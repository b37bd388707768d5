"""Attention (``paddle_tpu/ops/attention.py``): the additive (Bahdanau)
scores and context of the attention NMT model, ``dot_product_attention``
with its flash route, ``chunked_attention`` (the O(T)-memory online
softmax over key chunks, with packed rows' segment ids) and its dense
masked path, ``multi_head_attention`` for the local path,
``repeat_kv_heads`` for grouped KV heads, the 2-D ``padding_mask`` and
``segment_mask``, and rotary positions.  The
sequence-parallel ring (``mesh``, ``zigzag``) is not ported (ROADMAP
A12)."""

import math

import torch
from torch.utils import checkpoint

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.linear import matmul

_NEG = -1e30
# the JAX package's default threshold (PADDLE_TPU_CHUNKED_ATTN_MIN) above
# which an unmasked pair of lengths goes to chunked_attention
_CHUNKED_MIN = 2048 * 2048


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


def _logits_dtype(q):
    """JAX's ``preferred_element_type`` for the logits: the promotion of
    q's dtype and float32 (bf16 / f16 logits are formed in float32)."""
    return torch.promote_types(q.dtype, torch.float32)


def online_softmax_block(q, k, v, m_prev, l_prev, acc, mask=None,
                         scale=1.0, acc_dtype=None):
    """One K/V block of the online softmax (JAX's
    ``online_softmax_block``): q [..., Tq, D], k/v [..., Tk, D], m/l
    [..., Tq], acc [..., Tq, D], mask optional bool [..., Tq, Tk] ->
    the updated (m, l, acc).  The logits are formed in ``acc_dtype``
    (default: q's dtype promoted with float32), the weights cast to
    v's dtype before P.V, as JAX does.  A fully masked block's exp
    underflows to 0 and leaves the carry as it was."""
    acc_dtype = acc_dtype or _logits_dtype(q)
    s = torch.einsum("...qd,...kd->...qk", q.to(acc_dtype),
                     k.to(acc_dtype)) * scale
    if mask is not None:
        s = torch.where(mask, s, s.new_tensor(_NEG))
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "...qk,...kd->...qd", p.to(v.dtype), v)
    return m_new, l_new, acc_new


def _no_kv_labels_alone(q_segment_ids, kv_segment_ids):
    if kv_segment_ids is not None and q_segment_ids is None:
        raise ValueError(
            "kv_segment_ids without q_segment_ids: label the query side "
            "too (a lone KV labeling would be silently dropped)")


def chunked_attention(q, k, v, scale=None, causal=False, key_mask=None,
                      q_chunk=512, k_chunk=512, q_segment_ids=None,
                      kv_segment_ids=None):
    """Attention as an online softmax over key chunks inside a loop over
    query chunks (JAX's ``chunked_attention``): O(T) memory, no [Tq, Tk]
    matrix.  q [B, H, Tq, D], k/v [B, H, Tk, D]; ``key_mask`` [B, Tk]
    per-key validity; causal keeps key j for query i iff j <= i + Tk -
    Tq (the dense path's tril offset), and skips key chunks wholly above
    the diagonal.  ``q_segment_ids`` / ``kv_segment_ids`` [B, T] int
    labels of packed rows: query i attends key j iff their labels match,
    applied per chunk pair; padding rows of the last chunks carry labels
    -1 (queries) and -2 (keys), which match nothing.  With gradients
    on, each key chunk's update is recomputed in the backward
    (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``), so no
    [Tq, Tk] intermediate is kept."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (float(d) ** 0.5)
    q_chunk, k_chunk = min(q_chunk, tq), min(k_chunk, tk)
    pq, pk_ = (-tq) % q_chunk, (-tk) % k_chunk
    pad = torch.nn.functional.pad
    if pq:
        q = pad(q, (0, 0, 0, pq))
    if pk_ or key_mask is None:
        # padded keys are masked out through the O(T) validity vector
        km = torch.ones((b, tk), dtype=q.dtype, device=q.device) \
            if key_mask is None else key_mask.to(q.dtype)
        key_mask = pad(km, (0, pk_))
    if pk_:
        k = pad(k, (0, 0, 0, pk_))
        v = pad(v, (0, 0, 0, pk_))
    _no_kv_labels_alone(q_segment_ids, kv_segment_ids)
    segmented = q_segment_ids is not None
    if segmented:
        q_seg = pad(q_segment_ids.to(torch.int32), (0, pq), value=-1)
        kv_seg = pad((q_segment_ids if kv_segment_ids is None
                      else kv_segment_ids).to(torch.int32), (0, pk_),
                     value=-2)
    nq, nk = (tq + pq) // q_chunk, (tk + pk_) // k_chunk
    off = tk - tq
    acc_dtype = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))

    def update(m, l, acc, q_blk, k_blk, v_blk, keep):
        return online_softmax_block(q_blk, k_blk, v_blk, m, l, acc,
                                    mask=keep, scale=scale,
                                    acc_dtype=acc_dtype)

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        q_blk = q[:, :, qs]
        m = torch.full((b, h, q_chunk), _NEG, dtype=acc_dtype, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=acc_dtype, device=dev)
        acc = torch.zeros((b, h, q_chunk, d), dtype=acc_dtype, device=dev)
        for ki in range(nk):
            # key chunks wholly above the diagonal add nothing
            if causal and qi * q_chunk + q_chunk - 1 + off < ki * k_chunk:
                continue
            ks = slice(ki * k_chunk, (ki + 1) * k_chunk)
            keep = key_mask[:, None, None, ks] > 0
            if segmented:
                keep = keep & (q_seg[:, qs, None]
                               == kv_seg[:, None, ks])[:, None]
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=dev) + off
                kpos = ki * k_chunk + torch.arange(k_chunk, device=dev)
                keep = keep & (qpos[:, None] >= kpos[None, :])[None, None]
            args = (m, l, acc, q_blk, k[:, :, ks], v[:, :, ks], keep)
            m, l, acc = (checkpoint.checkpoint(update, *args,
                                               use_reentrant=False)
                         if remat else update(*args))
        outs.append((acc / torch.clamp(l[..., None], min=1e-20))
                    .to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :tq]


def padding_mask(q_len_mask, k_len_mask):
    """[B, Tq], [B, Tk] validity -> [B, 1, Tq, Tk] boolean mask (JAX's
    ``padding_mask``).  O(T^2), and it takes the dense path: a [B, Tk]
    ``key_mask`` to ``dot_product_attention`` is the O(T) form."""
    return (q_len_mask[:, None, :, None] > 0) \
        & (k_len_mask[:, None, None, :] > 0)


def segment_mask(q_segment_ids, kv_segment_ids=None):
    """[B, Tq], [B, Tk] int labels -> [B, 1, Tq, Tk] block-diagonal mask
    of packed rows (JAX's ``segment_mask``): label 0 is padding and
    matches nothing.  O(T^2): at long context ``chunked_attention``
    applies the labels per chunk pair instead."""
    kv = q_segment_ids if kv_segment_ids is None else kv_segment_ids
    same = q_segment_ids[:, None, :, None] == kv[:, None, None, :]
    return same & (q_segment_ids[:, None, :, None] > 0) \
        & (kv[:, None, None, :] > 0)


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False,
                          use_flash=None, key_mask=None,
                          q_segment_ids=None, kv_segment_ids=None):
    """q [B, H, Tq, Dh], k/v [B, H, Tk, Dh] -> [B, H, Tq, Dh], routed as
    JAX's ``dot_product_attention``.

    ``use_flash=None`` takes ``FlashAttention`` (the flash kernels,
    forward and backward) by JAX's rule — no mask, no segment ids, both
    lengths multiples of 128, causal only with Tq == Tk; the route is
    the same on both devices, since the kernel wrappers dispatch by
    device.  On that route a head dim ``_check.flash_head_dim`` admits
    runs the kernels; any other takes the path below.  Without a mask, Tq * Tk
    >= 2048^2 takes ``chunked_attention``; otherwise the dense masked
    path (the one ``_attend`` takes), with the segment ids' block mask.
    Masked logits sit at -1e30, whose exp is exactly 0.0; ``mask``
    broadcasts against [B, H, Tq, Tk]; ``key_mask`` [B, Tk] is per-key
    validity; ``q_segment_ids`` / ``kv_segment_ids`` [B, T] label packed
    rows (``segment_mask``)."""
    if mask is not None and key_mask is not None:
        raise ValueError("pass mask or key_mask, not both")
    _no_kv_labels_alone(q_segment_ids, kv_segment_ids)
    segmented = q_segment_ids is not None
    if use_flash and (mask is not None or key_mask is not None
                      or segmented):
        raise ValueError("the flash kernel has no mask support; drop "
                         "use_flash=True or the masking")
    if use_flash is None:
        use_flash = (mask is None and key_mask is None and not segmented
                     and q.shape[2] % 128 == 0 and k.shape[2] % 128 == 0
                     and (not causal or q.shape[2] == k.shape[2]))
    dh = q.shape[-1]
    if use_flash and _check.flash_head_dim(dh):
        from paddle_tpu_torch.ops.kernels.flash_attention import (
            FlashAttention)
        return FlashAttention.apply(q, k, v, scale, causal)
    if mask is None and q.shape[2] * k.shape[2] >= _CHUNKED_MIN:
        return chunked_attention(q, k, v, scale=scale, causal=causal,
                                 key_mask=key_mask,
                                 q_segment_ids=q_segment_ids,
                                 kv_segment_ids=kv_segment_ids)
    if segmented:
        seg = segment_mask(q_segment_ids, kv_segment_ids)
        mask = seg if mask is None else (mask & seg)
        if key_mask is not None:
            mask = mask & (key_mask[:, None, None, :] > 0)
    elif key_mask is not None:
        mask = key_mask[:, None, None, :] > 0
    scale = scale if scale is not None else 1.0 / math.sqrt(float(dh))
    acc = _logits_dtype(q)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    neg = logits.new_tensor(_NEG)
    if causal:
        tq, tk = logits.shape[-2:]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = torch.where(cm, logits, neg)
    if mask is not None:
        logits = torch.where(mask, logits, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


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
    (self-attention only); ``q_segment_ids`` / ``kv_segment_ids`` label
    packed rows (``dot_product_attention``).  ``mesh``/``zigzag`` (the
    sequence-parallel ring) raise."""
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
