from shine_tpu_torch.utils.stats import SearchStats, Statistics
from shine_tpu_torch.utils.timing import Timing

__all__ = ["Statistics", "SearchStats", "Timing"]
