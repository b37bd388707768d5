"""What the image models share: the He-normal conv init of the JAX
models (std sqrt(2 / fan_in), fan_in = k*k*cin), dropout from an
explicit generator, and the carry-across of a JAX parameter or state
tree."""

import math

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.utils.tree import tree_map


def he_conv(gen, kh, kw, cin, cout):
    """[kh, kw, cin, cout] (HWIO) normal with std sqrt(2 / (kh kw cin))."""
    return math.sqrt(2.0 / (kh * kw * cin)) * torch.randn(
        (kh, kw, cin, cout), generator=gen)


def normal(gen, std, shape):
    return std * torch.randn(shape, generator=gen)


def dropout(x, rate, rng):
    """Inverted dropout with ``rng`` (a ``torch.Generator``); the identity
    where ``rng`` is None, as JAX's models skip it without a key."""
    if rng is None:
        return x
    keep = torch.rand(x.shape, generator=rng, device=rng.device).to(
        x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def on_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def from_numpy(tree, want, device):
    """A JAX tree as numpy arrays -> float32 tensors on ``device``, after
    checking its keys and shapes against ``want`` (the port's own tree
    of the same config)."""
    def shapes(t, fn):
        if isinstance(t, dict):
            return {k: shapes(v, fn) for k, v in t.items()}
        return fn(t)
    got = shapes(tree, np.shape)
    expect = shapes(want, lambda t: tuple(t.shape))
    if got != expect:
        raise ValueError(f"parameter tree does not fit the model: got "
                         f"{got}, want {expect}")
    dev = _device.resolve(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=dev), tree)
