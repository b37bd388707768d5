"""Errors (copy of ``paddle_tpu/utils/error.py``; reference:
paddle/utils/Error.h)."""


class PaddleTpuError(Exception):
    """Base error for paddle_tpu_torch."""


class ConfigError(PaddleTpuError):
    """Invalid model / engine configuration."""


class ShapeError(PaddleTpuError):
    """Shape / size inference mismatch."""
