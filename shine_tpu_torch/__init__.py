"""shine_tpu_torch: the PyTorch/CUDA port of shine_tpu for one NVIDIA H100.

Serves batched HNSW k-NN queries. The graph is built by the JAX package's
jax-free native builder (``shine_tpu.graph``); the search runs in torch on
a CUDA card, with the candidate gather-and-score step in a hand-written
CUDA kernel (``csrc/gather_score.cu``), or on the CPU with that kernel's
plain torch twin. This package never imports JAX.
"""

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu_torch.convert import device_graph_from_jax
from shine_tpu_torch.models.hnsw import HNSWIndex

__all__ = ["HNSWParams", "SearchParams", "HNSWIndex", "device_graph_from_jax"]
