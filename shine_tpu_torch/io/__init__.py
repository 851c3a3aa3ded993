from shine_tpu_torch.io.checkpoint import (
    index_path,
    load_graph,
    load_graph_sharded,
    load_routed_split,
    save_graph,
    save_graph_sharded,
    save_routed_split,
)
from shine_tpu_torch.io.datasets import (
    DATASET_REGISTRY,
    Dataset,
    dataset_defaults,
    load_dataset,
    save_dataset,
    synthetic_dataset,
)
from shine_tpu_torch.io.fbin import read_bin, read_bin_header, write_bin
from shine_tpu_torch.io.recall import (
    brute_force_knn,
    gt_crosscheck,
    margin_mask,
    numpy_subset_gt,
    recall_at_k,
    recall_at_k_eps,
    recall_at_k_eps_regen,
)
from shine_tpu_torch.io.skew import skewed_workload, zipf_ranks

__all__ = [
    "Dataset",
    "synthetic_dataset",
    "load_dataset",
    "save_dataset",
    "DATASET_REGISTRY",
    "dataset_defaults",
    "read_bin",
    "read_bin_header",
    "write_bin",
    "skewed_workload",
    "zipf_ranks",
    "brute_force_knn",
    "gt_crosscheck",
    "numpy_subset_gt",
    "recall_at_k",
    "recall_at_k_eps",
    "recall_at_k_eps_regen",
    "margin_mask",
    "save_graph",
    "load_graph",
    "save_graph_sharded",
    "load_graph_sharded",
    "index_path",
    "save_routed_split",
    "load_routed_split",
]
