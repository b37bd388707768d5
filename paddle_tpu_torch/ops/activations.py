"""Activation registry (``paddle_tpu/ops/activations.py``; reference:
ActivationFunction.cpp) and ``sequence_softmax``."""

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


def sequence_softmax(x, mask):
    """Softmax over the time axis of a padded [B, T] (or [B, T, 1]) batch
    (reference SequenceSoftmaxActivation): padding is masked out before
    the softmax and comes out exactly 0; a row that is all padding comes
    out all 0, as JAX's ``jnp.where`` makes it, not NaN."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    if squeeze:
        x = x[..., 0]
    keep = mask > 0
    out = torch.softmax(torch.where(keep, x, x.new_tensor(float("-inf"))),
                        dim=-1)
    out = torch.where(keep, out, out.new_zeros(()))
    return out[..., None] if squeeze else out
