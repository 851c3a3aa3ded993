from shine_tpu_torch.io.checkpoint import (
    load_graph,
    load_routed_split,
    save_graph,
    save_routed_split,
)
from shine_tpu_torch.io.datasets import Dataset, synthetic_dataset
from shine_tpu_torch.io.recall import brute_force_knn, recall_at_k

__all__ = [
    "Dataset",
    "synthetic_dataset",
    "brute_force_knn",
    "recall_at_k",
    "save_graph",
    "load_graph",
    "save_routed_split",
    "load_routed_split",
]
