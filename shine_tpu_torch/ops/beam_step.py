"""One layer-0 HNSW beam step: the body of the JAX package's layer-0
``lax.while_loop`` (``shine_tpu/models/hnsw.py:_beam_search_l0_seeded``).

For every query of the batch a step picks the first ``frontier``
unexpanded beam entries, marks them expanded, gathers their layer-0
lists, scores the listed rows, merges them into the beam
(``ops/beam.py:beam_merge``) and adds the hops and the listed ids to the
counters. Steps run in lockstep: launch t does its work only while
``unsettled[t]`` is not 0, and adds the number of queries it leaves
unsettled (``term``: "ef", an unexpanded entry among the ef; "k", among the
first k) into ``unsettled[t + 1]``. A loop may therefore launch several
steps before it reads the count back; the launches after the last active
step change nothing.

``beam_step`` launches the fused CUDA kernel (``csrc/gather_score.cu``)
for tensors on a card and runs its plain twin ``beam_step_ref`` for
tensors on the CPU. The twin scores through ``gather_score``, so on a card
the two agree bit for bit. Both update the beam, the counters and
``unsettled`` in place.
"""

from __future__ import annotations

import torch

from shine_tpu_torch.ops import _build
from shine_tpu_torch.ops.beam import (
    Beam,
    beam_frontier_multi,
    beam_mark_expanded,
    beam_merge,
)
from shine_tpu_torch.ops.gather_score import (
    ROW_TYPES,
    check_rows,
    check_tensor,
    gather_score,
)

# the kernel's limits (csrc/gather_score.cu), checked before a launch
MAX_EF = 512
MAX_LANES = 1024  # frontier * list width
MAX_SMEM = 48 * 1024


def settle_limit(ef: int, k: int, term: str) -> int:
    """How many leading beam entries must be expanded for a query to be
    settled: ef under term "ef", k under "k"."""
    if term not in ("ef", "k"):
        raise ValueError(f"term must be 'ef' or 'k', got {term!r}")
    if not 1 <= k <= ef:
        raise ValueError(f"k={k} must be in [1, ef={ef}]")
    return ef if term == "ef" else k


def unsettled_count(expanded: torch.Tensor, limit: int) -> torch.Tensor:
    """int32 count of the queries with an unexpanded entry among their
    first ``limit`` beam entries."""
    return (~expanded[:, :limit]).any(dim=1).sum(dtype=torch.int32)


def frontier_lists(
    beam: Beam, neighbors0: torch.Tensor, frontier: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slots (B, E), active (B, E), lanes (B, E * W) int32): the step's
    frontier and its lists, -1 where a slot is inactive or a list pads."""
    B = beam.ids.shape[0]
    slots, fids, active = beam_frontier_multi(beam, frontier)
    nbrs = neighbors0[fids.clamp_min(0).long()]  # (B, E, W)
    nbrs = torch.where(active[:, :, None], nbrs, -1).reshape(B, -1)
    return slots, active, nbrs


def kept_lanes(beam_ids: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """(B, L) bool: the lanes whose distance can reach ``beam_merge``'s
    output, the rest being pads, ids already in the beam or repeats of an
    earlier lane. One stable sort of the beam's ids followed by the lanes
    finds each id's first copy."""
    ef = beam_ids.shape[1]
    ids = torch.cat([beam_ids, lanes], 1)
    s, perm = torch.sort(ids, dim=1, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    first = torch.zeros_like(first).scatter_(1, perm, first)
    return first[:, ef:] & (lanes >= 0)


def beam_step_ref(
    vectors: torch.Tensor,  # (N, d) f32 | bf16 | int8
    neighbors0: torch.Tensor,  # (N, W) int32, -1 pad
    q_ext: torch.Tensor,  # (B, d) f32
    bias: torch.Tensor,  # (B,) f32
    beam: Beam,  # (B, ef) each, updated in place
    hops: torch.Tensor,  # (B,) int32, updated in place
    counts: torch.Tensor,  # (B,) int32 exact distance counts, in place
    unsettled: torch.Tensor,  # (S,) int32, t + 1 < S
    t: int,
    *,
    frontier: int,
    k: int,
    term: str,
    l2: bool = True,
    row_scl: torch.Tensor | None = None,
    row_nrm: torch.Tensor | None = None,
) -> None:
    """The plain step: ``beam_frontier_multi``, ``beam_mark_expanded``, the
    list gather, ``gather_score``, ``beam_merge`` and the counters."""
    if int(unsettled[t]) == 0:
        return
    slots, active, nbrs = frontier_lists(beam, neighbors0, frontier)
    marked = beam_mark_expanded(beam, slots, active)
    d = gather_score(vectors, q_ext, bias, nbrs, row_scl=row_scl,
                     row_nrm=row_nrm if l2 else None, l2=l2)
    new = beam_merge(marked, d, nbrs)
    for dst, src in zip(beam, new):
        dst.copy_(src)
    hops += active.sum(dim=1, dtype=torch.int32)
    counts += (nbrs >= 0).sum(dim=1, dtype=torch.int32)
    limit = settle_limit(beam.ids.shape[1], k, term)
    unsettled[t + 1] += unsettled_count(new.expanded, limit)


def beam_step(
    vectors: torch.Tensor,
    neighbors0: torch.Tensor,
    q_ext: torch.Tensor,
    bias: torch.Tensor,
    beam: Beam,
    hops: torch.Tensor,
    counts: torch.Tensor,
    unsettled: torch.Tensor,
    t: int,
    *,
    frontier: int,
    k: int,
    term: str,
    l2: bool = True,
    row_scl: torch.Tensor | None = None,
    row_nrm: torch.Tensor | None = None,
) -> None:
    """One beam step, in place; see ``beam_step_ref``. The beam must be
    ``beam_merge``'s output (sorted, distinct ids, pads last) and the lists
    must hold ids in [-1, N). The inputs are checked on either device; CPU
    tensors then take the plain twin, CUDA tensors launch the kernel,
    counted in ``beam_step.launches``. On a card, ef above ``MAX_EF``,
    ``frontier`` times the list width above ``MAX_LANES`` or a step whose
    shared memory exceeds ``MAX_SMEM`` raise."""
    check_rows(vectors, row_scl, row_nrm, l2)
    dev = vectors.device
    N, d = vectors.shape
    B, ef = beam.ids.shape
    W = neighbors0.shape[1] if neighbors0.dim() == 2 else -1
    check_tensor("neighbors0", neighbors0, torch.int32, (N, W), dev)
    check_tensor("q_ext", q_ext, torch.float32, (B, d), dev)
    check_tensor("bias", bias, torch.float32, (B,), dev)
    check_tensor("beam.dists", beam.dists, torch.float32, (B, ef), dev)
    check_tensor("beam.ids", beam.ids, torch.int32, (B, ef), dev)
    check_tensor("beam.expanded", beam.expanded, torch.bool, (B, ef), dev)
    check_tensor("hops", hops, torch.int32, (B,), dev)
    check_tensor("counts", counts, torch.int32, (B,), dev)
    S = unsettled.shape[0] if unsettled.dim() == 1 else -1
    check_tensor("unsettled", unsettled, torch.int32, (S,), dev)
    if not 0 <= t < S - 1:
        raise ValueError(f"step t={t} needs unsettled[t + 1]; it has {S} entries")
    if frontier < 1:
        raise ValueError("frontier must be >= 1")
    settle = settle_limit(ef, k, term)
    kw = dict(frontier=frontier, k=k, term=term, l2=l2, row_scl=row_scl,
              row_nrm=row_nrm)
    if dev.type == "cpu":
        return beam_step_ref(vectors, neighbors0, q_ext, bias, beam, hops,
                             counts, unsettled, t, **kw)
    if ef > MAX_EF or frontier * W > MAX_LANES:
        raise ValueError(f"beam_step takes ef <= {MAX_EF} and frontier * list "
                         f"width <= {MAX_LANES}, got ef={ef}, "
                         f"{frontier} x {W}")
    lib = _build.load()
    smem = lib.shine_beam_step_smem(ef, frontier, W, d)
    if smem > MAX_SMEM:
        raise ValueError(f"beam_step at ef={ef}, {frontier} x {W} lanes, d={d} "
                         f"needs {smem} B of shared memory, over {MAX_SMEM}")
    if B == 0:
        return None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shine_beam_step(
            vectors.data_ptr(), ROW_TYPES[vectors.dtype], q_ext.data_ptr(),
            bias.data_ptr(),
            row_scl.data_ptr() if row_scl is not None else None,
            row_nrm.data_ptr() if row_nrm is not None and l2 else None,
            neighbors0.data_ptr(), beam.dists.data_ptr(), beam.ids.data_ptr(),
            beam.expanded.data_ptr(), hops.data_ptr(), counts.data_ptr(),
            unsettled.data_ptr(), t, N, B, ef, frontier, W, d, settle, int(l2),
            stream,
        )
    _build.check(rc, "beam_step")
    beam_step.launches += 1
    return None


beam_step.launches = 0
