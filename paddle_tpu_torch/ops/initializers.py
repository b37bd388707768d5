"""Parameter initializers (``paddle_tpu/ops/initializers.py``).

Each returns ``init(generator, shape, dtype=None)`` drawing on the
generator's device.  The std rules are the JAX package's (reference
default: normal with std 1/sqrt(fan_in), fan_in = shape[0]); the random
bits are PyTorch's, not JAX's.
"""

import math

import torch


def _dtype(dtype):
    return dtype or torch.float32


def constant(value=0.0):
    def init(gen, shape, dtype=None):
        return torch.full(shape, value, dtype=_dtype(dtype),
                          device=gen.device)
    return init


def normal(std=None, mean=0.0):
    """std=None -> reference default 1/sqrt(fan_in) (fan_in = shape[0])."""
    def init(gen, shape, dtype=None):
        s = std if std is not None else 1.0 / math.sqrt(max(shape[0], 1))
        return mean + s * torch.randn(shape, generator=gen,
                                      dtype=_dtype(dtype), device=gen.device)
    return init


def uniform(scale=None):
    """U(-scale, scale); scale=None -> 1/sqrt(fan_in)."""
    def init(gen, shape, dtype=None):
        s = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        u = torch.rand(shape, generator=gen, dtype=_dtype(dtype),
                       device=gen.device)
        return (2.0 * u - 1.0) * s
    return init
