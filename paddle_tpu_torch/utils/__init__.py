"""Host-side utilities (JAX-free copies of ``paddle_tpu/utils``).  The
exports are JAX's, less ``FLAGS`` (ROADMAP A5)."""

from paddle_tpu_torch.utils.error import ConfigError, PaddleTpuError, \
    ShapeError
from paddle_tpu_torch.utils.logging import get_logger, logger
from paddle_tpu_torch.utils.stats import Stat, global_stats, \
    print_all_stats, timer

__all__ = [
    "logger",
    "get_logger",
    "Stat",
    "global_stats",
    "timer",
    "print_all_stats",
    "PaddleTpuError",
    "ConfigError",
    "ShapeError",
]
