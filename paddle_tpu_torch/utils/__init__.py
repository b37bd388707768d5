"""Host-side utilities (JAX-free copies of ``paddle_tpu/utils``), with
JAX's exports: the logger, the stats registry, the process ``FLAGS``
(``utils/flags``) and the error types."""

from paddle_tpu_torch.utils.logging import get_logger, logger
from paddle_tpu_torch.utils.stats import Stat, global_stats, \
    print_all_stats, timer
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.error import ConfigError, PaddleTpuError, \
    ShapeError

__all__ = [
    "logger",
    "get_logger",
    "Stat",
    "global_stats",
    "timer",
    "print_all_stats",
    "FLAGS",
    "PaddleTpuError",
    "ConfigError",
    "ShapeError",
]
