"""Activation registry (``paddle_tpu/ops/activations.py``; reference:
ActivationFunction.cpp).  ``sequence_softmax`` is not ported yet
(ROADMAP)."""

import torch

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name):
    if callable(name):
        return name
    if name in (None, "", "linear", "identity"):
        return lambda x: x
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; have "
                       f"{sorted(_REGISTRY)}") from None


def names():
    return sorted(_REGISTRY)


register("sigmoid")(torch.sigmoid)
register("relu")(torch.relu)
register("tanh")(torch.tanh)
register("abs")(torch.abs)
register("square")(torch.square)
register("exponential")(torch.exp)
register("sqrt")(lambda x: torch.sqrt(torch.clamp(x, min=0.0)))


@register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register("log")
def log(x):
    return torch.log(torch.clamp(x, min=1e-20))


@register("brelu")
def brelu(x):
    # reference BReluActivation: min(max(x, 0), 24)
    return torch.clamp(x, 0.0, 24.0)


@register("softrelu")
def softrelu(x):
    # reference SoftReluActivation: log(1 + exp(clip(x, -40, 40)))
    return torch.log1p(torch.exp(torch.clamp(x, -40.0, 40.0)))


@register("stanh")
def stanh(x):
    # reference STanhActivation: 1.7159 * tanh(2/3 x)
    return 1.7159 * torch.tanh((2.0 / 3.0) * x)
