"""The port's sharded paths on a one-process shard mesh (``mesh.py``): the
sharded HNSW search with its owner-computed exchange, hot-vertex replica
and query routing (``sharded.py``, ``hot_cache.py``, ``placement.py``,
``router.py``) and the sharded exact scan (``flat_sharded.py``)."""

from shine_tpu_torch.parallel.flat_sharded import ShardedFlatIndex
from shine_tpu_torch.parallel.hot_cache import (
    AccessCounter,
    HotReplica,
    build_replica,
    replica_lookup,
    select_hot_ids,
)
from shine_tpu_torch.parallel.mesh import ShardMesh, shard_mesh
from shine_tpu_torch.parallel.placement import Placement, capacity_assign, kmeans
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
    "ShardedFlatIndex",
    "ShardedGraph",
    "ShardedIndex",
    "SlackController",
    "build_replica",
    "build_upper_tables",
    "capacity_assign",
    "kmeans",
    "make_sharded_search",
    "replica_lookup",
    "select_hot_ids",
    "shard_graph",
    "shard_mesh",
]
