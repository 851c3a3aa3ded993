"""The routed class-max scan, K4: the port of
``shine_tpu/ops/pallas_scan_routed.py``.

The table is cluster-major: cluster c holds rows c*cap .. c*cap + cap - 1
of ``comp`` ((C+1)*cap rows or more, bf16 or int8, the last cluster C a pad
cluster), and ``aux_r`` (C+1, 2*members, cls) holds each cluster's nrm rows,
then its scl rows (members = cap // cls). The B = G*T queries come in G
groups of T; group g scans only the P clusters ``cols[g]`` names. For query
b of group g and class lane l, over the codes ``code = p*members + m`` in
increasing order,

    score = scl[cols[g, p], m, l] * <q[b], comp[cols[g, p]*cap + m*cls + l]>
            + nrm[cols[g, p], m, l]

(the product and the sum rounded once each), and the scan keeps the best
score and its code, the earliest code winning a tie (strict ``>`` from
the start state (NEG, 0), so a score at or below NEG never enters). It
returns best (B, cls) f32 and rows (B, cls) int32 = code*cls + lane; the
table row of a survivor is ``cols[g, row // cap]*cap + row % cap``. Pad
columns name cluster C, whose nrm is NEG, so no mask is needed; rows of
``comp`` past (C+1)*cap are never read.

On a CPU tensor ``routed_classmax_scan`` runs its plain twin
``routed_classmax_scan_ref``; on a CUDA tensor it launches the hand-written
kernel, the routed walk of ``csrc/classmax2_scan.cu``, or raises. It
counts its launches in ``.launches`` and by (comp dtype, T) in
``.form_launches``. The kernel skips the columns that name the pad
cluster, so the function requires cluster C to be one: its rows all zero
and its nrm at or below NEG, as the build makes it.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.ops import classmax as cm
from shine_tpu_torch.ops.distance import matmul_nt
from shine_tpu_torch.ops.scan_split import NEG

_KERNEL_MAX_T = 64  # queries a group: the kernel's wgmma N is 16, 32 or 64


def aux_routed_layout(aux: torch.Tensor, C: int, cap: int, cls: int) -> torch.Tensor:
    """(2, C*cap) f32 flat aux -> (C, 2*members, cls) cluster-block aux."""
    members = cap // cls
    a = aux.reshape(2, C, members, cls)
    return a.movedim(0, 1).reshape(C, 2 * members, cls)


def aux_routed_layout_chunk(aux_c: torch.Tensor, cap: int, cls: int) -> torch.Tensor:
    """``aux_routed_layout`` of a (2, rchunk) piece whose rchunk is a
    multiple of cap: (rchunk // cap, 2*members, cls). Stacking the pieces
    gives the layout of the whole."""
    return aux_routed_layout(aux_c, aux_c.shape[1] // cap, cap, cls)


def routed_classmax_scan_ref(comp, aux_r, q, cols, *, T, cap, cls):
    """Plain twin of ``routed_classmax_scan``: the XLA emulation of the JAX
    package's ``scan_select``, one group at a time (gathering every group's
    blocks at once would take G*P*cap rows). f32 products of the bf16
    queries and the table (each product exact in f32), times scl, plus
    nrm, the first maximum over the codes."""
    B, dpc = q.shape
    G, P = cols.shape
    members = cap // cls
    dev = q.device
    comp3 = comp[: aux_r.shape[0] * cap].view(aux_r.shape[0], cap, dpc)
    qf = q.to(torch.float32).view(G, T, dpc)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    lane = torch.arange(cls, dtype=torch.int32, device=dev)
    best = torch.empty((B, cls), dtype=torch.float32, device=dev)
    rows = torch.empty((B, cls), dtype=torch.int32, device=dev)
    for g in range(G):
        c = cols[g].long()
        dots = matmul_nt(qf[g], comp3[c].view(P * cap, dpc))
        aux_b = aux_r[c]  # (P, 2*members, cls)
        nrm = aux_b[:, :members].reshape(P * members, cls)
        scl = aux_b[:, members:].reshape(P * members, cls)
        sc = dots.view(T, P * members, cls) * scl + nrm
        sc = torch.where(sc > neg, sc, neg)  # at or below NEG never enters
        mx, first = cm._max_first(sc)
        best[g * T:(g + 1) * T] = mx
        rows[g * T:(g + 1) * T] = first * cls + lane
    return best, rows


def _check(comp, aux_r, q, cols, T: int, cap: int, cls: int) -> None:
    """What the function needs of its inputs, and on a card what the kernel
    needs; raises on anything else."""
    cm._check_device(comp)
    cm._check_2d("comp", comp, (torch.bfloat16, torch.int8))
    cm._check_2d("q", q, (torch.bfloat16,))
    cm._check_2d("cols", cols, (torch.int32,))
    if aux_r.dtype != torch.float32 or aux_r.dim() != 3 or not aux_r.is_contiguous():
        raise TypeError(f"aux_r must be a contiguous 3-D float32 tensor, got "
                        f"{aux_r.dtype} {tuple(aux_r.shape)}")
    for t in (aux_r, q, cols):
        if t.device != comp.device:
            raise ValueError(f"an input is on {t.device}, comp on {comp.device}")
    if cls <= 0 or cap <= 0 or cap % cls:
        raise ValueError(f"cap={cap} must be a positive multiple of cls={cls}")
    C1 = aux_r.shape[0]  # the clusters and the pad cluster
    if tuple(aux_r.shape[1:]) != (2 * (cap // cls), cls):
        raise ValueError(f"aux_r must be ({C1}, {2 * (cap // cls)}, {cls}), got "
                         f"{tuple(aux_r.shape)}")
    if comp.shape[0] < C1 * cap:
        raise ValueError(f"comp holds {comp.shape[0]} rows, fewer than the "
                         f"{C1} x {cap} the clusters need")
    if q.shape[1] != comp.shape[1]:
        raise ValueError(f"query width {q.shape[1]} != table width {comp.shape[1]}")
    G = cols.shape[0]
    if T <= 0 or q.shape[0] != G * T:
        raise ValueError(f"{q.shape[0]} queries are not {G} groups of T={T}")
    # one device read: cols in range, and cluster C a pad cluster (comp 0,
    # nrm <= NEG), which the kernel skips
    C = C1 - 1
    ok = ((aux_r[C, : cap // cls] <= NEG).all()
          & ~comp[C * cap:C1 * cap].to(torch.bool).any())
    if cols.numel():
        ok &= (cols.min() >= 0) & (cols.max() <= C)
    if not bool(ok):
        raise ValueError(f"cols must name clusters 0..{C}, and cluster {C} must be "
                         "the pad cluster (comp 0, nrm <= NEG)")
    if comp.device.type == "cuda":
        dpc = comp.shape[1]
        if dpc % 16 or dpc > cm._KERNEL_MAX_DPC:
            raise ValueError(f"the kernel takes widths that are multiples of 16 "
                             f"up to {cm._KERNEL_MAX_DPC}, got {dpc}")
        if cls % cm._KERNEL_CLASS_TILE:
            raise ValueError(f"the kernel needs cls % {cm._KERNEL_CLASS_TILE} == 0, "
                             f"got {cls}")
        if T > _KERNEL_MAX_T:
            raise ValueError(f"the kernel takes groups of at most {_KERNEL_MAX_T} "
                             f"queries, got T={T}")
        if C1 * cap >= 2**31:
            raise ValueError("row ids must fit in int32")
        if any(t.data_ptr() % 16 for t in (comp, aux_r, q)):
            raise ValueError("the kernel's inputs must be 16-byte aligned")


def routed_classmax_scan(comp, aux_r, q, cols, *, T, cap, cls):
    """(best (B, cls) f32, rows (B, cls) int32) of bf16 ``q`` (G*T, dpc)
    against the clusters ``cols`` (G, P) int32 of the cluster-major
    ``comp`` (bf16 or int8) and ``aux_r`` (C+1, 2*cap/cls, cls) f32."""
    _check(comp, aux_r, q, cols, T, cap, cls)
    if comp.device.type == "cpu":
        return routed_classmax_scan_ref(comp, aux_r, q, cols, T=T, cap=cap, cls=cls)
    G, P = cols.shape
    int8 = comp.dtype == torch.int8

    def scan(lib, stream, best, rows, *_):
        return lib.shine_classmax_scan_routed(
            comp.data_ptr(), int(int8), aux_r.data_ptr(), q.data_ptr(),
            cols.data_ptr(), aux_r.shape[0] - 1, G, T, P, comp.shape[1], cap, cls,
            best, rows, stream)

    return cm._launch(routed_classmax_scan, scan, q.shape[0], cls, None, False,
                      comp.device, ("int8" if int8 else "bf16", T))


routed_classmax_scan.launches = 0
routed_classmax_scan.form_launches = {}
