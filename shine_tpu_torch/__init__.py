"""shine_tpu_torch: the PyTorch/CUDA port of shine_tpu for one NVIDIA H100.

Serves batched HNSW k-NN queries, near-exact brute-force queries and
cluster-pruned (IVF and routed) queries. The graph is built by the port's own
native builder (``graph``, ``native``), at scan speed on the card
(``models/fastbuild.py``: an exact kNN sweep through the class-max or
block-max scans, a batched diversity select, the native reverse merge), or
by batched insert rounds on the card (``models/build.py``:
``device_build_graph``, ``insert_round``), which also let
``DynamicHNSWIndex`` (``models/dynamic.py``) take inserts while it serves;
the HNSW search runs each layer-0 beam step (frontier, lists, duplicate
drop, row scoring, merge) as one launch of a hand-written CUDA kernel
(``csrc/gather_score.cu``); ``FastFlatIndex`` scans a packed bf16 table,
``SplitFlatIndex`` a split bf16 or int8 table (the class-max scans of
``csrc/classmax2_scan.cu``) and ``RoutedSplitIndex`` the clusters its
query tiles ask for in a clustered split table (the routed scan, also in
``csrc/classmax2_scan.cu``); FastFlat's block-max route runs the block-max
scan of ``csrc/classmax2_scan.cu``; ``IVFIndex`` (``models/ivf.py``) scores
each query's probed clusters, or each query tile's shared ones, with torch
products, as the JAX package does with XLA. The command line, ``python -m
shine_tpu_torch`` (``cli.py``), builds or loads any of them from dataset
files (``io/fbin.py``, ``io/datasets.py``) or a synthetic set, serves a
plain or Zipf-skewed workload (``io/skew.py``) and prints the run's
Statistics document (``utils/``). The row-keyed datasets
(``io/device_synth.py``) regenerate any base row from its id
(``ops/threefry.py``, the kernels of ``csrc/regen_rows.cu``), so the flat
and routed indexes serve bases larger than the card holds as f32, re-ranking
exactly from regenerated rows. ``parallel/`` serves the HNSW graph sharded
over a one-process mesh of S shards (``ShardedIndex``: the owner-computed
exchange, dense or compact, a hot-vertex replica, query routing; every
distance through ``gather_score``), the exact scan sharded by rows
(``ShardedFlatIndex``), and the scan families sharded: FastFlat and the
split tables by rows (``ShardedFastFlatIndex``, ``ShardedSplitFlatIndex``),
IVF and the routed family by clusters (``ShardedIVFIndex``,
``ShardedRoutedSplitIndex``, ``build_routed_split_sharded``); on the one card
the shards stack. Entry points run
on the CUDA card unless the caller names another device; on the CPU each kernel's plain torch twin
runs instead. This package imports neither JAX nor the JAX package.
"""

from shine_tpu_torch.config import HNSWParams, SearchParams, auto_index_family
from shine_tpu_torch.convert import (
    build_state_from_jax,
    device_graph_from_jax,
    fastflat_from_jax,
    ivf_from_jax,
    replica_from_jax,
    routed_split_from_jax,
    row_source_from_jax,
    sharded_fastflat_from_jax,
    sharded_graph_from_jax,
    sharded_ivf_from_jax,
    sharded_routed_from_jax,
    sharded_splitflat_from_jax,
    splitflat_from_jax,
)
from shine_tpu_torch.models.build import (
    device_build_graph,
    init_build_state,
    insert_round,
)
from shine_tpu_torch.models.dynamic import DynamicHNSWIndex
from shine_tpu_torch.models.fastbuild import fast_build_graph
from shine_tpu_torch.models.flat import FastFlatIndex, FlatIndex, SplitFlatIndex
from shine_tpu_torch.models.hnsw import HNSWIndex
from shine_tpu_torch.models.ivf import IVFIndex
from shine_tpu_torch.models.routed_split import RoutedSplitIndex, build_routed_split
from shine_tpu_torch.parallel import (
    ShardedFastFlatIndex,
    ShardedFlatIndex,
    ShardedIndex,
    ShardedIVFIndex,
    ShardedRoutedSplitIndex,
    ShardedSplitFlatIndex,
    build_routed_split_sharded,
    shard_mesh,
)
from shine_tpu_torch.utils import SearchStats, Statistics, Timing

__all__ = [
    "HNSWParams",
    "SearchParams",
    "auto_index_family",
    "Statistics",
    "SearchStats",
    "Timing",
    "HNSWIndex",
    "FlatIndex",
    "FastFlatIndex",
    "SplitFlatIndex",
    "IVFIndex",
    "RoutedSplitIndex",
    "build_routed_split",
    "fast_build_graph",
    "device_build_graph",
    "init_build_state",
    "insert_round",
    "DynamicHNSWIndex",
    "device_graph_from_jax",
    "build_state_from_jax",
    "fastflat_from_jax",
    "splitflat_from_jax",
    "routed_split_from_jax",
    "ivf_from_jax",
    "row_source_from_jax",
    "ShardedIndex",
    "ShardedFlatIndex",
    "ShardedFastFlatIndex",
    "ShardedSplitFlatIndex",
    "ShardedIVFIndex",
    "ShardedRoutedSplitIndex",
    "build_routed_split_sharded",
    "shard_mesh",
    "sharded_graph_from_jax",
    "replica_from_jax",
    "sharded_fastflat_from_jax",
    "sharded_splitflat_from_jax",
    "sharded_ivf_from_jax",
    "sharded_routed_from_jax",
]
