"""Attention (``paddle_tpu/ops/attention.py``): the additive (Bahdanau)
scores and context of the attention NMT model, ``dot_product_attention``
with its flash route and its dense masked path, ``multi_head_attention``
for the local path, ``repeat_kv_heads`` for grouped KV heads, and rotary
positions.  The sequence-parallel ring (``mesh``, ``zigzag``), packed
rows (segment ids) and ``chunked_attention`` are not ported (ROADMAP
A2, A12)."""

import math

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.linear import matmul

_NEG = -1e30
# the JAX package's default threshold (PADDLE_TPU_CHUNKED_ATTN_MIN) above
# which an unmasked pair of lengths goes to chunked_attention
_CHUNKED_MIN = 2048 * 2048
_ROADMAP = "not yet ported to paddle_tpu_torch (ROADMAP A2)"
_LANES = _check.LANES


def additive_attention_scores(enc_proj: SequenceBatch, dec_state_proj, v):
    """Bahdanau scores v . tanh(enc_proj + dec_proj): enc_proj.data
    [B, T, A] (projected once per sequence, outside the decode loop),
    dec_state_proj [B, A], v [A] -> [B, T], -1e30 at padding.  Plain
    PyTorch, as in JAX: no kernel is involved."""
    e = torch.tanh(enc_proj.data + dec_state_proj[:, None, :])
    scores = torch.einsum("bta,a->bt", e, v)
    return torch.where(enc_proj.bool_mask(), scores, scores.new_tensor(_NEG))


def attention_context(scores, values: SequenceBatch):
    """softmax(scores) @ values -> [B, D]; the weights are masked and
    renormalised by max(sum, 1e-9), so an empty row gives zeros."""
    w = torch.softmax(scores, dim=-1)
    w = w * values.mask(w.dtype)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return torch.einsum("bt,btd->bd", w, values.data)


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False,
                          use_flash=None, key_mask=None,
                          q_segment_ids=None, kv_segment_ids=None):
    """q [B, H, Tq, Dh], k/v [B, H, Tk, Dh] -> [B, H, Tq, Dh].

    ``use_flash=None`` takes ``FlashAttention`` (the flash kernels,
    forward and backward) by JAX's rule — no mask, both lengths
    multiples of 128, causal only with Tq == Tk; the route is the same
    on both devices, since the kernel wrappers dispatch by device.  On
    that route, as in JAX's ``flash_attention``, a head dim up to 128
    runs the kernels (those between 16, 32, 64 and 128 zero-padded to
    the next), a wider one that is not a multiple of 128 takes the dense
    path, and a multiple of 128 above 128 raises (ROADMAP B8).
    Otherwise the dense masked path (the one ``_attend`` takes).  Masked
    logits sit at -1e30, whose exp is exactly 0.0; ``mask`` broadcasts
    against [B, H, Tq, Tk]; ``key_mask`` [B, Tk] is per-key validity.
    Where JAX would take ``chunked_attention`` (no mask, Tq * Tk >=
    2048^2) this raises rather than build the [Tq, Tk] matrix."""
    if mask is not None and key_mask is not None:
        raise ValueError("pass mask or key_mask, not both")
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError(f"segment ids (packed rows) are {_ROADMAP}")
    if use_flash and (mask is not None or key_mask is not None):
        raise ValueError("the flash kernel has no mask support; drop "
                         "use_flash=True or the masking")
    if use_flash is None:
        use_flash = (mask is None and key_mask is None
                     and q.shape[2] % 128 == 0 and k.shape[2] % 128 == 0
                     and (not causal or q.shape[2] == k.shape[2]))
    dh = q.shape[-1]
    if use_flash and dh > _LANES and dh % _LANES:
        # JAX's flash_attention leaves a head dim its lanes cannot tile
        # to the dense path (paddle_tpu/ops/pallas/flash_attention.py:382)
        use_flash = False
    if use_flash:
        if dh > _LANES:
            raise NotImplementedError(
                f"the flash kernels at head dim {dh} (they take any up to "
                f"{_LANES}) are not yet ported to paddle_tpu_torch "
                "(ROADMAP B8)")
        from paddle_tpu_torch.ops.kernels.flash_attention import (
            FlashAttention)
        return FlashAttention.apply(q, k, v, scale, causal)
    if mask is None and q.shape[2] * k.shape[2] >= _CHUNKED_MIN:
        raise NotImplementedError(
            f"chunked_attention (Tq={q.shape[2]} x Tk={k.shape[2]} without "
            f"a mask) is {_ROADMAP}")
    if key_mask is not None:
        mask = key_mask[:, None, None, :] > 0
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


def multi_head_attention(x_q, x_kv, wq, wk, wv, wo, num_heads, mask=None,
                         causal=False, key_mask=None, mesh=None,
                         zigzag=False, q_segment_ids=None,
                         kv_segment_ids=None, rope_positions=None):
    """Dense multi-head attention, the local path.  x_q [B, Tq, D], x_kv
    [B, Tk, D], wq/wo [D, D], wk/wv [D, Dkv]: grouped KV heads are read
    from the weight shapes and repeated up to full heads before
    ``dot_product_attention``.  ``rope_positions`` rotates q and k
    (self-attention only).  ``mesh``/``zigzag`` (the sequence-parallel
    ring) raise."""
    if mesh is not None or zigzag:
        raise NotImplementedError("sequence-parallel attention (mesh, "
                                  "zigzag) is not yet ported to "
                                  "paddle_tpu_torch (ROADMAP A12)")
    b, tq, d = x_q.shape
    tk = x_kv.shape[1]
    dh = d // num_heads
    if wk.shape[1] % dh:
        raise ValueError(f"wk projects to {wk.shape[1]} dims, not a "
                         f"multiple of head dim {dh}")
    if wv.shape[1] != wk.shape[1]:
        raise ValueError(f"wk ({wk.shape[1]}) and wv ({wv.shape[1]}) "
                         "must project to the same grouped-KV width")
    hkv = wk.shape[1] // dh

    def split(x, w, t, h):
        return matmul(x, w).reshape(b, t, h, dh).transpose(1, 2)

    q = split(x_q, wq, tq, num_heads)
    k = split(x_kv, wk, tk, hkv)
    v = split(x_kv, wv, tk, hkv)
    if rope_positions is not None:
        if tq != tk:
            raise ValueError(
                "rope_positions requires self-attention (Tq == Tk); "
                "cross-attention has no shared position stream")
        q = rope(q, rope_positions)
        k = rope(k, rope_positions)
    out = dot_product_attention(q, repeat_kv_heads(k, num_heads),
                                repeat_kv_heads(v, num_heads), mask=mask,
                                causal=causal, key_mask=key_mask,
                                q_segment_ids=q_segment_ids,
                                kv_segment_ids=kv_segment_ids)
    return matmul(out.transpose(1, 2).reshape(b, tq, d), wo)


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
