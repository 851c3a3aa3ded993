"""Exact k-NN sharded over a mesh: the port of
``shine_tpu/parallel/flat_sharded.py``.

Each shard holds an equal row range of the base and scans it for the whole
replicated query batch (``models/flat.py:flat_search``); the shards' local
top-k lanes meet in one ``all_gather`` of (B, k) lanes and one (dist, id)
sort, the only traffic between shards.
"""

from __future__ import annotations

import numpy as np
import torch

from shine_tpu_torch.config import METRIC_L2, metric_id
from shine_tpu_torch.models.flat import CHUNK_QUANTUM, flat_search
from shine_tpu_torch.ops.beam import dist_id_key
from shine_tpu_torch.ops.distance import squared_norms
from shine_tpu_torch.parallel.mesh import ShardMesh


def merge_topk(mesh: ShardMesh, dd: list[torch.Tensor], ii: list[torch.Tensor],
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge of every sharded scan: all-gather the shards' (B, w)
    (dist, global id) lanes and keep the k best by (dist, id), -1 ids last
    among equal dists: (dists (B, k), ids (B, k)) on the first shard's
    device."""
    S = mesh.size
    B = dd[0].shape[0]
    all_d = mesh.all_gather(dd)[0].reshape(S, B, -1).transpose(0, 1).reshape(B, -1)
    all_i = mesh.all_gather(ii)[0].reshape(S, B, -1).transpose(0, 1).reshape(B, -1)
    pos = torch.topk(dist_id_key(all_d, all_i), min(k, all_d.shape[1]), dim=1,
                     largest=False, sorted=True)[1]
    return torch.gather(all_d, 1, pos), torch.gather(all_i, 1, pos)


class ShardedFlatIndex:
    """Exact k-NN over the shards of ``mesh``."""

    def __init__(self, vectors: np.ndarray, mesh: ShardMesh,
                 metric: str | int = "l2"):
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.size
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = v.shape
        rows = -(-n // (S * CHUNK_QUANTUM)) * CHUNK_QUANTUM  # a shard's rows
        n_pad = rows * S
        if n_pad != n:
            v = np.concatenate([v, np.zeros((n_pad - n, dim), np.float32)])
        self.data = []
        for s, dev in enumerate(mesh.devices):
            vs = torch.from_numpy(v[s * rows:(s + 1) * rows]).to(dev)
            # the norms of FlatIndex, on the shard's device
            sq = (squared_norms(vs) if self.metric == METRIC_L2
                  else torch.zeros(rows, device=dev))
            valid = torch.arange(s * rows, (s + 1) * rows, device=dev) < n
            # a shard's rows are all valid to flat_search; pad rows are
            # masked by their inf norms
            self.data.append({"vectors": vs, "vectors_bf16": vs.to(torch.bfloat16),
                              "sqnorms": torch.where(valid, sq, torch.inf),
                              "n": rows})
        self.n, self.dim, self.rows = n, dim, rows

    def _search_batch(self, q: torch.Tensor, k: int, chunk: int,
                      use_bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
        S = self.mesh.size
        qs = self.mesh.replicate(q)
        dd, ii = [], []
        for s in range(S):
            ld, li = flat_search(self.data[s], qs[s], k=k, chunk=chunk,
                                 metric=self.metric, use_bf16=use_bf16)
            dd.append(ld)
            ii.append(torch.where(li >= 0, li + s * self.rows, -1))
        return merge_topk(self.mesh, dd, ii, k)

    def search(self, queries: np.ndarray, k: int = 10, *,
               batch_size: int = 4096, chunk: int = 65536,
               use_bf16: bool = True) -> tuple[np.ndarray, np.ndarray]:
        nq, d = queries.shape
        chunk = min(chunk, self.rows)
        batch_size = min(batch_size, max(nq, 1))
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = np.zeros((batch_size, d), np.float32)
            q[: hi - lo] = queries[lo:hi]
            dd, ii = self._search_batch(torch.from_numpy(q), k, chunk, use_bf16)
            out_d[lo:hi] = dd[: hi - lo].cpu().numpy()
            out_i[lo:hi] = ii[: hi - lo].cpu().numpy()
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, batch_size: int = 4096,
                      use_bf16: bool = True) -> dict:
        """The cluster's analytic cost, the JAX package's count: the table
        scan split over the shards; between shards, the replicated queries
        out and the (dist, id) top-k lanes back."""
        S = self.mesh.size
        n_pad = self.rows * S
        batches = -(-nq // max(batch_size, 1))
        table = n_pad * self.dim * (2 if use_bf16 else 4)
        return {
            "distance_computations": nq * n_pad + (nq * 2 * k if use_bf16 else 0),
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * table
            + (nq * 2 * k * self.dim * 4 if use_bf16 else 0),
            "ici_exchange_bytes": nq * self.dim * 4 * (S - 1)
            + nq * k * 8 * (S - 1),
        }
