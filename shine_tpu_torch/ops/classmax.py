"""The class-max scans: K2, the port of ``shine_tpu/ops/pallas_scan3.py``,
and K3, the port of ``shine_tpu/ops/pallas_scan_split.py``.

Every row r of the table belongs to class ``r % cls``. For each query the
scan keeps, per class, the best score and its row (strict ``>`` in
increasing row order, so the earliest row wins a tie; a score at or below
NEG never enters, the start state being (NEG, row = lane)) and, in the
``classmax2_*`` forms and with ``keep2``, the runner-up by ``_kernel2``'s
demotion rule. The ``*_topk_*`` forms end with an exact top-kb over the
class lanes (value descending, the lower lane winning a tie) and gather
the rows (and runner-ups) at the picked lanes: the same as the unfused
form followed by ``select_lanes`` and a gather.

K2 scores ``<q_ext, ext[row]>`` on the packed bf16 table; K3 scores
``scl[row] * <q, comp[row]> + nrm[row]`` on a bf16 or int8 component
table and its (2, N_pad) f32 ``aux`` (``ops/scan_split.py``), the product
and the sum rounded once each.

Each function takes the JAX signature; ``tq`` and ``tn`` are accepted and
pick no tiling. CPU tensors take the plain twin (``*_ref``), CUDA tensors
launch the hand-written kernel of ``csrc/classmax2_scan.cu`` (the
``*_topk_*`` forms then the select kernel of ``csrc/classmax_scan.cu``) or
raise;
each wrapper counts its launches in ``<wrapper>.launches`` (the K3
wrappers also by (comp dtype, keep2) in ``<wrapper>.form_launches``).
"""

from __future__ import annotations

import torch

from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops.beam import smallest_positions
from shine_tpu_torch.ops.distance import matmul_nt
from shine_tpu_torch.ops.scan import NEG

CLS = 1024
TN = 2048
_REF_ROWS = 32_768  # rows the twin scores per step
_KERNEL_CLASS_TILE = 64  # classes per CTA of the kernel
_KERNEL_MAX_DP = 1304  # widest table whose query tile fits in shared memory
_KERNEL_MAX_DPC = 1280  # the same for a split table, beside its aux ring


def _max_first(dd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max over dim 1 of (B, M, cls) and the first index reaching it; the
    value is the first index's own, so that of +0.0 and -0.0 tied the
    earlier one's sign is kept, as the strict > keeps it."""
    mx = dd.amax(dim=1)
    idx = torch.arange(dd.shape[1], dtype=torch.int32, device=dd.device)
    first = torch.where(dd == mx[:, None, :], idx[None, :, None],
                        dd.shape[1]).amin(dim=1)
    return (torch.gather(dd, 1, first[:, None, :].long()).squeeze(1),
            first.to(torch.int32))


def _classmax_ref(ext: torch.Tensor, q_ext: torch.Tensor, cls: int,
                  keep2: bool, aux: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, ...]:
    """The plain twin of every form: f32 products over chunks of rows (a
    bf16 product is exact in f32), times ``aux[1]`` plus ``aux[0]`` when
    ``aux`` is given (the split score, two roundings), the chunk's best
    (and runner-up) member per class, merged into the running state with
    earlier rows winning ties."""
    n_pad = ext.shape[0]
    B = q_ext.shape[0]
    members = n_pad // cls
    per = max(1, _REF_ROWS // cls)
    dev = ext.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    s1 = neg.expand(B, cls).clone()
    c1 = torch.zeros((B, cls), dtype=torch.int32, device=dev)
    s2, c2 = s1.clone(), c1.clone()
    qf = q_ext.to(torch.float32)
    for m0 in range(0, members, per):
        m1 = min(m0 + per, members)
        lo, hi = m0 * cls, m1 * cls
        dd = matmul_nt(qf, ext[lo:hi])
        if aux is not None:
            dd = dd * aux[1, lo:hi] + aux[0, lo:hi]
        dd = dd.view(B, m1 - m0, cls)
        dd = torch.where(dd > neg, dd, neg)  # at or below NEG never enters
        mx, first = _max_first(dd)
        win = mx > s1
        if keep2:
            rest = dd.scatter(1, first[:, None, :].long(), -torch.inf)
            mx2, first2 = _max_first(rest)
            # the runner-up: the better of the old winner and the chunk's
            # runner-up when the chunk wins, else of the old runner-up and
            # the chunk's winner; ties go to the earlier rows
            keep_old1 = s1 >= mx2
            keep_old2 = s2 >= mx
            s2 = torch.where(win, torch.where(keep_old1, s1, mx2),
                             torch.where(keep_old2, s2, mx))
            c2 = torch.where(win, torch.where(keep_old1, c1, first2 + m0),
                             torch.where(keep_old2, c2, first + m0))
        s1 = torch.where(win, mx, s1)
        c1 = torch.where(win, first + m0, c1)
    lane = torch.arange(cls, dtype=torch.int32, device=dev)
    out = (s1, c1 * cls + lane)
    if keep2:
        out += (s2, c2 * cls + lane)
    return out


def select_lanes(best: torch.Tensor, kb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-kb of each row of ``best`` (B, cls): (values (B, kb),
    lanes (B, kb) int64) in value-descending order, the lower lane first
    among equal values, as ``lax.top_k`` orders them (-0.0 and +0.0 tie,
    as in the Pallas epilogue and the CUDA select)."""
    sel = smallest_positions(-best, kb)
    return torch.gather(best, 1, sel), sel


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis of f32 ``x``: (values, positions
    (int64)), largest first, the lower position first among equal values,
    and +0.0 above -0.0 (the float's total order, as ``lax.top_k`` takes
    it; ``select_lanes`` ties the two zeros instead). The routed select and
    the block-max route take it, as their JAX counterparts take
    ``lax.top_k``."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    okey = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    sel = torch.topk((-okey << 32) + pos, k, dim=-1, largest=False).indices
    return torch.gather(x, -1, sel), sel


def _topk_ref(ext, q_ext, cls, kb, keep2, aux=None):
    out = _classmax_ref(ext, q_ext, cls, keep2, aux)
    vals, sel = select_lanes(out[0], kb)
    return (vals,) + tuple(torch.gather(o, 1, sel) for o in out[1:])


def classmax_scan_ref(ext, q_ext, *, cls=CLS):
    """Plain twin of ``classmax_scan``."""
    return _classmax_ref(ext, q_ext, cls, False)


def classmax2_scan_ref(ext, q_ext, *, cls=CLS):
    """Plain twin of ``classmax2_scan``."""
    return _classmax_ref(ext, q_ext, cls, True)


def classmax_topk_scan_ref(ext, q_ext, *, kb, cls=CLS):
    """Plain twin of ``classmax_topk_scan``."""
    return _topk_ref(ext, q_ext, cls, kb, False)


def classmax2_topk_scan_ref(ext, q_ext, *, kb, cls=CLS):
    """Plain twin of ``classmax2_topk_scan``."""
    return _topk_ref(ext, q_ext, cls, kb, True)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the class-max scan runs on cpu or cuda, not {t.device}")


def _check_2d(name: str, t: torch.Tensor, dtypes: tuple) -> None:
    if t.dtype not in dtypes or t.dim() != 2:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} must be a 2-D {names} tensor, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_shape(table: torch.Tensor, q: torch.Tensor, cls: int,
                 kb: int | None, max_width: int, *others: torch.Tensor) -> None:
    """What every form needs of its table (N_pad, dp) and queries (B, dp),
    and on a card what the kernel needs (``others``: further inputs that
    must share the card and be 16-byte aligned)."""
    for t in (q,) + others:
        if t.device != table.device:
            raise ValueError(f"an input is on {t.device}, the table on "
                             f"{table.device}")
    n_pad, dp = table.shape
    if q.shape[1] != dp:
        raise ValueError(f"query width {q.shape[1]} != table width {dp}")
    if cls <= 0 or n_pad % cls:
        raise ValueError(f"the table's {n_pad} rows must be a multiple of cls={cls}")
    if kb is not None and not 1 <= kb <= cls:
        raise ValueError(f"kb={kb} must lie in [1, cls={cls}]")
    if table.device.type == "cuda":
        if dp % 16 or dp > max_width:
            raise ValueError(f"the kernel takes widths that are multiples of 16 "
                             f"up to {max_width}, got {dp}")
        if cls % _KERNEL_CLASS_TILE:
            raise ValueError(f"the kernel needs cls % {_KERNEL_CLASS_TILE} == 0, "
                             f"got {cls}")
        if n_pad >= 2**31:
            raise ValueError("row ids must fit in int32")
        if any(t.data_ptr() % 16 for t in (table, q) + others):
            raise ValueError("the kernel's inputs must be 16-byte aligned")


def _check(ext: torch.Tensor, q_ext: torch.Tensor, cls: int, kb: int | None) -> None:
    _check_device(ext)
    _check_2d("ext", ext, (torch.bfloat16,))
    _check_2d("q_ext", q_ext, (torch.bfloat16,))
    _check_shape(ext, q_ext, cls, kb, _KERNEL_MAX_DP)


def _launch(wrapper, scan, B: int, cls: int, kb: int | None, keep2: bool,
            dev: torch.device, form: tuple | None = None
            ) -> tuple[torch.Tensor, ...]:
    """Run the scan kernel (``scan(lib, stream, best, rows, best2, rows2)``
    on output pointers) and, given kb, the select kernel, on the card
    ``dev``, adding one to ``wrapper.launches`` (and, given a form, to
    ``wrapper.form_launches[form]``) once the scan has launched. An empty
    batch launches nothing and counts nothing."""

    def planes(width):
        ps = [torch.empty((B, width), dtype=torch.float32, device=dev),
              torch.empty((B, width), dtype=torch.int32, device=dev)]
        if keep2:
            ps += [torch.empty((B, width), dtype=torch.float32, device=dev),
                   torch.empty((B, width), dtype=torch.int32, device=dev)]
        return ps

    def ptrs(ps):
        return [p.data_ptr() for p in ps] + [None] * (4 - len(ps))

    full = planes(cls)
    if B == 0:
        return tuple(full if kb is None else planes(kb))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(scan(lib, stream, *ptrs(full)), wrapper.__name__)
        wrapper.launches += 1
        if form is not None:
            wrapper.form_launches[form] = wrapper.form_launches.get(form, 0) + 1
        if kb is None:
            return tuple(full)
        picked = planes(kb)
        _build.check(lib.shine_classmax_select(
            *ptrs(full), B, cls, kb, *ptrs(picked), stream), "classmax_select")
    return tuple(picked)


def _run(wrapper, ext, q_ext, cls, kb, keep2):
    _check(ext, q_ext, cls, kb)
    if ext.device.type == "cpu":
        if kb is None:
            return _classmax_ref(ext, q_ext, cls, keep2)
        return _topk_ref(ext, q_ext, cls, kb, keep2)
    n_pad, dp = ext.shape

    def scan(lib, stream, *out):
        return lib.shine_classmax_scan(ext.data_ptr(), q_ext.data_ptr(), n_pad,
                                       q_ext.shape[0], dp, cls, int(keep2),
                                       *out, stream)

    return _launch(wrapper, scan, q_ext.shape[0], cls, kb, keep2, ext.device)


def classmax_scan(ext, q_ext, *, tq=1024, tn=TN, cls=CLS):
    """(best (B, cls) f32, rows (B, cls) int32) of bf16 ``q_ext`` (B, dp)
    against the bf16 table ``ext`` (N_pad, dp)."""
    return _run(classmax_scan, ext, q_ext, cls, None, False)


def classmax2_scan(ext, q_ext, *, tq=512, tn=TN, cls=CLS):
    """(best, rows, best2, rows2), each (B, cls): the class winners and
    runner-ups."""
    return _run(classmax2_scan, ext, q_ext, cls, None, True)


def classmax_topk_scan(ext, q_ext, *, kb, tq=1024, tn=TN, cls=CLS):
    """(best (B, kb), rows (B, kb)): ``classmax_scan`` followed by an exact
    top-kb over the lanes and a gather."""
    return _run(classmax_topk_scan, ext, q_ext, cls, kb, False)


def classmax2_topk_scan(ext, q_ext, *, kb, tq=512, tn=TN, cls=CLS):
    """(best, rows, best2, rows2), each (B, kb): ``classmax2_scan`` with the
    four planes gathered at the top-kb lanes of ``best``."""
    return _run(classmax2_topk_scan, ext, q_ext, cls, kb, True)


# --- K3: the split-layout scan -----------------------------------------------

def classmax_scan_split_ref(comp, aux, q, *, cls=CLS, keep2=False):
    """Plain twin of ``classmax_scan_split``."""
    return _classmax_ref(comp, q, cls, keep2, aux)


def classmax_topk_scan_split_ref(comp, aux, q, *, kb, cls=CLS, keep2=False):
    """Plain twin of ``classmax_topk_scan_split``."""
    return _topk_ref(comp, q, cls, kb, keep2, aux)


def _run_split(wrapper, comp, aux, q, cls, kb, keep2):
    _check_device(comp)
    _check_2d("comp", comp, (torch.bfloat16, torch.int8))
    _check_2d("aux", aux, (torch.float32,))
    _check_2d("q", q, (torch.bfloat16,))
    if aux.shape != (2, comp.shape[0]):
        raise ValueError(f"aux must be (2, {comp.shape[0]}), got {tuple(aux.shape)}")
    _check_shape(comp, q, cls, kb, _KERNEL_MAX_DPC, aux)
    if comp.device.type == "cpu":
        if kb is None:
            return _classmax_ref(comp, q, cls, keep2, aux)
        return _topk_ref(comp, q, cls, kb, keep2, aux)
    n_pad, dpc = comp.shape
    int8 = comp.dtype == torch.int8

    def scan(lib, stream, *out):
        return lib.shine_classmax_scan_split(
            comp.data_ptr(), int(int8), aux.data_ptr(), q.data_ptr(), n_pad,
            q.shape[0], dpc, cls, int(keep2), *out, stream)

    return _launch(wrapper, scan, q.shape[0], cls, kb, keep2, comp.device,
                   ("int8" if int8 else "bf16", bool(keep2)))


def classmax_scan_split(comp, aux, q, *, tq=512, tn=2048, cls=CLS, keep2=False):
    """(best (B, cls) f32, rows (B, cls) int32[, best2, rows2]) of the split
    score of bf16 ``q`` (B, dpc) against ``comp`` (N_pad, dpc) bf16 or int8
    and ``aux`` (2, N_pad) f32 [nrm; scl]."""
    return _run_split(classmax_scan_split, comp, aux, q, cls, None, keep2)


def classmax_topk_scan_split(comp, aux, q, *, kb, tq=512, tn=2048, cls=CLS,
                             keep2=False):
    """(best (B, kb), rows (B, kb)[, best2, rows2]): ``classmax_scan_split``
    followed by an exact top-kb over the lanes and a gather."""
    return _run_split(classmax_topk_scan_split, comp, aux, q, cls, kb, keep2)


for _f in (classmax_scan, classmax2_scan, classmax_topk_scan,
           classmax2_topk_scan, classmax_scan_split, classmax_topk_scan_split):
    _f.launches = 0
for _f in (classmax_scan_split, classmax_topk_scan_split):
    _f.form_launches = {}
