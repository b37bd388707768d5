"""Layer norm (``paddle_tpu/ops/norm.py``)."""

import torch


def layer_norm(x, gamma, beta, eps=1e-6):
    """Normalize over the last axis with the biased variance, as
    ``jnp.var`` computes it, then scale and shift."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta
