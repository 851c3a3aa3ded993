"""Fixed-width beam (sorted candidate/result set) for batched best-first
search: the PyTorch port of ``shine_tpu.ops.beam``.

Each query's working set is a (dist, id, expanded) triple of width ef,
sorted by (dist, id) ascending, the reference's tie-break
(src/hnsw/heap.hh:53-57). ``beam_merge`` keeps the best ef
entries and collapses duplicate ids, which makes a visited set
unnecessary (see the JAX module's docstring for the argument). Every
function here returns exactly what its JAX twin returns, bit for bit.

Padding convention: id = -1, dist = +inf, expanded = True.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")
_ID_PAD_KEY = 2**31 - 1  # -1 pads sort after every real id


class Beam(NamedTuple):
    dists: torch.Tensor  # (B, ef) float32, ascending
    ids: torch.Tensor  # (B, ef) int32, -1 pad
    expanded: torch.Tensor  # (B, ef) bool, True pad


def beam_init(batch: int, ef: int, device: torch.device | str = "cpu") -> Beam:
    return Beam(
        dists=torch.full((batch, ef), INF, dtype=torch.float32, device=device),
        ids=torch.full((batch, ef), -1, dtype=torch.int32, device=device),
        expanded=torch.ones((batch, ef), dtype=torch.bool, device=device),
    )


def _id_key(ids: torch.Tensor) -> torch.Tensor:
    return torch.where(ids < 0, _ID_PAD_KEY, ids).to(torch.int64)


def dist_id_key(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key whose order is the (dist, id) order of f32 ``d`` (no NaN)
    and integer ``ids`` (-1 last among equal dists): the float's ordered
    bits fill the high word, the id the low word. Adding 0.0 turns -0.0
    into +0.0, so the two compare equal, as in ``lax.sort``."""
    bits = (d.to(torch.float32) + 0.0).view(torch.int32)
    fkey = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return (fkey << 32) + _id_key(ids)


def smallest_positions(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (int64) of the k smallest entries of each row of ``d``,
    ascending, the lower position first among equal values:
    ``lax.top_k(-d, k)``'s order, with -0.0 and +0.0 tied."""
    pos = torch.arange(d.shape[1], device=d.device).expand_as(d)
    return torch.sort(dist_id_key(d, pos), dim=1)[1][:, :k]


def _sort_by(key: torch.Tensor, *cols: torch.Tensor) -> list[torch.Tensor]:
    """Stable sort of each row by ``key``, carrying ``cols`` along."""
    _, perm = torch.sort(key, dim=1, stable=True)
    return [torch.gather(c, 1, perm) for c in cols]


def beam_merge(
    beam: Beam,
    cand_dists: torch.Tensor,  # (B, K) float32
    cand_ids: torch.Tensor,  # (B, K) int32, -1 = masked out
) -> Beam:
    """Merge K candidates per query into the beam, keeping the best ef.

    Duplicate ids (already in the beam, or repeated among the candidates)
    collapse to one entry whose expanded flag is the OR of the copies.
    Each of the JAX version's two-key ``lax.sort`` passes is one stable
    sort on an int64 key that packs both keys, primary in the high word.
    """
    ef = beam.ids.shape[1]
    valid = cand_ids >= 0
    all_d = torch.cat([beam.dists, torch.where(valid, cand_dists, INF)], 1)
    all_i = torch.cat([beam.ids, torch.where(valid, cand_ids, -1)], 1)
    all_e = torch.cat([beam.expanded, torch.zeros_like(valid)], 1)
    # pass 1: group same ids, expanded copies first
    ik = _id_key(all_i)
    ik, d, i, e = _sort_by(ik * 2 + (~all_e).to(torch.int64), ik, all_d, all_i, all_e)
    dup = torch.zeros_like(e)
    dup[:, 1:] = ik[:, 1:] == ik[:, :-1]
    d = torch.where(dup, INF, d)
    i = torch.where(dup, -1, i)
    e = dup | e
    # pass 2: order by (dist, id), keep the best ef
    d, i, e = (c[:, :ef] for c in _sort_by(dist_id_key(d, i), d, i, e))
    pad = i < 0
    return Beam(dists=torch.where(pad, INF, d), ids=i, expanded=pad | e)


def beam_frontier(beam: Beam) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query's nearest unexpanded entry: (slot (B,), id (B,), active
    (B,)); active is False when every entry is expanded."""
    masked = torch.where(beam.expanded, INF, beam.dists)
    slot = torch.argmin(masked, dim=1)
    fid = torch.gather(beam.ids, 1, slot[:, None])[:, 0]
    active = ~torch.all(beam.expanded, dim=1)
    return slot, torch.where(active, fid, -1), active


def beam_frontier_multi(
    beam: Beam, width: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query's ``width`` nearest unexpanded entries: the beam is
    sorted, so they are the first ``width`` unexpanded slots (a cumsum).

    Returns (slots (B, width) int64, ids (B, width) int32, active (B,
    width) bool). Unpicked slots scatter into a spare last column, the
    counterpart of JAX's ``mode="drop"``, which is then cut off.
    """
    B, ef = beam.ids.shape
    unexp = ~beam.expanded
    rank = torch.cumsum(unexp.to(torch.int64), dim=1) - 1
    tgt = torch.where(unexp & (rank < width), rank, width)
    cols = torch.arange(ef, device=tgt.device).expand(B, ef)
    slots = torch.zeros((B, width + 1), dtype=torch.int64, device=tgt.device)
    slots = slots.scatter_(1, tgt, cols)[:, :width]
    active = torch.zeros((B, width + 1), dtype=torch.bool, device=tgt.device)
    active = active.scatter_(1, tgt, True)[:, :width]
    fids = torch.where(active, torch.gather(beam.ids, 1, slots), -1)
    return slots, fids, active


def beam_mark_expanded(
    beam: Beam, slot: torch.Tensor, active: torch.Tensor
) -> Beam:
    """Mark one slot (B,) or several slots (B, E) as expanded."""
    if slot.dim() == 1:
        slot, active = slot[:, None], active[:, None]
    B, ef = beam.ids.shape
    col = torch.where(active, slot.to(torch.int64), ef)
    pad = torch.zeros((B, 1), dtype=torch.bool, device=col.device)
    exp = torch.cat([beam.expanded, pad], 1).scatter_(1, col, True)[:, :ef]
    return beam._replace(expanded=exp)
