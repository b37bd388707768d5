"""Attention pieces of the LM trunk (``paddle_tpu/ops/attention.py``):
the masked path of ``dot_product_attention``, ``repeat_kv_heads`` for
grouped KV heads, and rotary positions."""

import math

import torch

_NEG = -1e30


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False):
    """q [B, H, Tq, Dh], k/v [B, H, Tk, Dh] -> [B, H, Tq, Dh]: the dense
    masked path (the one ``_attend`` takes).  Masked logits sit at
    -1e30, whose exp is exactly 0.0; ``mask`` broadcasts against
    [B, H, Tq, Tk]."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(float(dh))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg = logits.new_tensor(_NEG)
    if causal:
        tq, tk = logits.shape[-2:]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = torch.where(cm, logits, neg)
    if mask is not None:
        logits = torch.where(mask, logits, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def repeat_kv_heads(kv, num_heads):
    """[B, Hkv, T, D] -> [B, H, T, D]: each KV head repeated over its
    query group (GQA); Hkv == H is a no-op."""
    hkv = kv.shape[1]
    if hkv == num_heads:
        return kv
    if num_heads % hkv:
        raise ValueError(f"num_heads={num_heads} not divisible by "
                         f"num_kv_heads={hkv}")
    return torch.repeat_interleave(kv, num_heads // hkv, dim=1)


def rope(x, positions, base=10000.0):
    """Rotary position embedding: rotate head-dim halves of x
    [..., H, T, D] by per-position angles.  positions: [T] or [B, T]
    integers."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    half = d // 2
    freq = base ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq   # [..., T, half]
    ang = ang[None, None] if ang.ndim == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)
