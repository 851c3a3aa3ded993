"""The port's sharded paths on a one-process shard mesh (``mesh.py``): the
sharded HNSW search with its owner-computed exchange, hot-vertex replica
and query routing (``sharded.py``, ``hot_cache.py``, ``placement.py``,
``router.py``), the sharded exact scan (``flat_sharded.py``), and the
sharded scan families: the row-sharded class-max scans
(``fastflat_sharded.py``: ``ShardedFastFlatIndex``, ``ShardedSplitFlatIndex``),
cluster-sharded IVF (``ivf_sharded.py``) and cluster-sharded routed split
serving with its direct build (``routed_sharded.py``)."""

from shine_tpu_torch.parallel.fastflat_sharded import (
    ShardedFastFlatIndex,
    ShardedSplitFlatIndex,
)
from shine_tpu_torch.parallel.flat_sharded import ShardedFlatIndex
from shine_tpu_torch.parallel.hot_cache import (
    AccessCounter,
    HotReplica,
    build_replica,
    replica_lookup,
    select_hot_ids,
)
from shine_tpu_torch.parallel.ivf_sharded import ShardedIVFIndex
from shine_tpu_torch.parallel.mesh import ShardMesh, shard_mesh
from shine_tpu_torch.parallel.placement import Placement, capacity_assign, kmeans
from shine_tpu_torch.parallel.routed_sharded import (
    ShardedRoutedSplitIndex,
    build_routed_split_sharded,
)
from shine_tpu_torch.parallel.router import AdaptiveQueryRouter, QueryRouter
from shine_tpu_torch.parallel.sharded import (
    ShardedGraph,
    ShardedIndex,
    SlackController,
    build_upper_tables,
    make_sharded_search,
    shard_graph,
)

__all__ = [
    "AccessCounter",
    "AdaptiveQueryRouter",
    "HotReplica",
    "Placement",
    "QueryRouter",
    "ShardMesh",
    "ShardedFastFlatIndex",
    "ShardedFlatIndex",
    "ShardedGraph",
    "ShardedIVFIndex",
    "ShardedIndex",
    "ShardedRoutedSplitIndex",
    "ShardedSplitFlatIndex",
    "SlackController",
    "build_replica",
    "build_routed_split_sharded",
    "build_upper_tables",
    "capacity_assign",
    "kmeans",
    "make_sharded_search",
    "replica_lookup",
    "select_hot_ids",
    "shard_graph",
    "shard_mesh",
]
