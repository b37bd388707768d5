"""Mixture-of-experts FFN (``paddle_tpu/ops/moe.py``): dense top-k gating
with renormalization (Switch / GShard style) over experts run as one
batched product over the expert dim.  Every expert runs on every token;
the gates select afterwards, so no shape depends on the routing.  The
three products are XLA's in JAX, so they are ``torch.einsum`` here.

``expert_shardings`` (experts over a mesh's ``expert`` axis) waits for
ROADMAP A12.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch import device as _device


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def init_moe(generator, d_model, d_ff, n_experts, device=None):
    """``{"wg": [D, E], "w1": [E, D, F], "w2": [E, F, D]}`` drawn from
    ``generator`` (the port's own random bits, JAX's scales: the gate and
    w1 normal at 1/sqrt(D), w2 at 1/sqrt(F)), on ``device`` (the card
    unless "cpu")."""
    dev = _device.resolve(device)
    scale = 1.0 / math.sqrt(d_model)

    def normal(shape, s):
        return (s * torch.randn(shape, generator=generator,
                                device=generator.device)).to(dev)

    return {"wg": normal((d_model, n_experts), scale),
            "w1": normal((n_experts, d_model, d_ff), scale),
            "w2": normal((n_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff))}


def router_probs(x, wg):
    """Softmax router probabilities: x [..., D], wg [D, E] -> [..., E]."""
    return torch.softmax(x @ wg, dim=-1)


def top_k_mask(probs, top_k):
    """[..., E] 0/1 mask of the ``top_k`` largest probabilities, EXACTLY
    ``top_k`` per row; among tied values the lower index is kept, as
    ``jax.lax.top_k`` keeps it (a stable descending sort: ``torch.topk``
    promises no order among ties)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros_like(probs)
    return mask.scatter_(-1, idx[..., :top_k], 1.0)


def moe_gates(probs, top_k):
    """Top-k gates from router probs, renormalized over the kept experts;
    exactly ``top_k`` experts stay nonzero even on tied probabilities (an
    index mask, not a >= threshold)."""
    if top_k >= probs.shape[-1]:
        return probs
    kept = probs * top_k_mask(probs, top_k)
    return kept / torch.clamp(kept.sum(-1, keepdim=True), min=1e-9)


def aux_load_balance_loss(probs, gates, top_k, valid=None):
    """GShard / Switch auxiliary loss: E * sum_e(share of tokens picking e
    * mean router prob of e), 1 at uniform use.  ``valid`` [...]: a token
    mask; the statistics then count real tokens only."""
    e = probs.shape[-1]
    picked = (gates > 0).to(probs.dtype).reshape(-1, e)
    flat = probs.reshape(-1, e)
    if valid is None:
        frac = picked.mean(0) / max(top_k, 1)
        mean_prob = flat.mean(0)
    else:
        w = valid.to(probs.dtype).reshape(-1, 1)
        n = torch.clamp(w.sum(), min=1.0)
        frac = (picked * w).sum(0) / n / max(top_k, 1)
        mean_prob = (flat * w).sum(0) / n
    return e * torch.sum(frac * mean_prob)


def moe_ffn(x, params, top_k=2, act=_gelu_tanh, return_aux=False,
            valid=None):
    """x [B, T, D] -> [B, T, D] through E gated FFN experts (all experts
    as one batched product; the router runs once).  ``return_aux=True``
    also returns the load-balance loss of the same probs and gates,
    restricted to ``valid`` [B, T] tokens when given."""
    probs = router_probs(x, params["wg"])
    gates = moe_gates(probs, top_k)
    h = act(torch.einsum("btd,edf->btef", x, params["w1"]))
    y = torch.einsum("btef,efd->bted", h, params["w2"])
    out = torch.einsum("bted,bte->btd", y, gates)
    if return_aux:
        return out, aux_load_balance_loss(probs, gates, top_k, valid)
    return out
