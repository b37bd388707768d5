"""``from paddle.trainer.config_parser import parse_config, logger``
during a port parse (reference python/paddle/trainer/config_parser.py)."""

import logging

from paddle_tpu_torch.compat.config_parser import parse_config  # noqa: F401

logger = logging.getLogger("paddle_tpu_torch.config_parser")

__all__ = ["parse_config", "logger"]
