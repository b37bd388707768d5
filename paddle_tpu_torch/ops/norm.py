"""Batch, layer and RMS norm (``paddle_tpu/ops/norm.py``; reference
BatchNormBaseLayer / BatchNormalizationLayer / CudnnBatchNorm with
use_global_stats switching and moving-average accumulation).

``batch_norm_train`` returns ``(y, (new_moving_mean, new_moving_var))``
so the moving stats thread through a step as explicit state, as in
JAX.  It normalizes with the BIASED variance and keeps ``momentum`` of
the old stats (0.9 keeps 0.9 of them), the biased variance going into
the moving one too: not ``F.batch_norm(training=True)``, whose running
stats take the unbiased variance and whose momentum weighs the new
value.  The new stats carry no gradient (JAX's trainers take the state
as aux, never differentiating it).
"""

import torch


def batch_norm_train(x, gamma, beta, moving_mean, moving_var,
                     momentum=0.9, eps=1e-5, axis=None):
    """Normalize over all axes except the channel (last) axis.

    Returns (y, (new_moving_mean, new_moving_var))."""
    if axis is None:
        axis = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=axis)
    var = torch.var(x, dim=axis, unbiased=False)
    y = (x - mean) / torch.sqrt(var + eps)
    y = y * gamma + beta
    mean, var = mean.detach(), var.detach()
    new_mean = momentum * moving_mean + (1.0 - momentum) * mean
    new_var = momentum * moving_var + (1.0 - momentum) * var
    return y, (new_mean, new_var)


def batch_norm_infer(x, gamma, beta, moving_mean, moving_var, eps=1e-5):
    y = (x - moving_mean) / torch.sqrt(moving_var + eps)
    return y * gamma + beta


def layer_norm(x, gamma, beta, eps=1e-6):
    """Normalize over the last axis with the biased variance, as
    ``jnp.var`` computes it, then scale and shift."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def rms_norm(x, gamma, eps=1e-6):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x / torch.sqrt(ms + eps) * gamma
