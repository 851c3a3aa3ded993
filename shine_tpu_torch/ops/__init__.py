"""Tensor operations of the port: beam, distances, the kernels' wrappers."""

from shine_tpu_torch.ops.distance import (
    candidate_distance,
    pairwise_distance,
    squared_norms,
)

__all__ = ["pairwise_distance", "candidate_distance", "squared_norms"]
