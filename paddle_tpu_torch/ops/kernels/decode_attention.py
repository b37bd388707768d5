"""Chunked slab decode attention — the attention of the default serving
step (``models/transformer.lm_decode_chunk_slots``).

Port of ``paddle_tpu/ops/pallas/decode_attention.py ::
decode_attention_slab_chunk`` (same signature and contract).  The kernel
is ``csrc/decode_attention.cu``; ``decode_attention_slab_chunk_plain``
is its plain PyTorch version, which the CPU takes and which
``chip_smoke.py`` holds the kernel against on the card.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops.kernels import _build, _check

NAME = "decode_attention_slab_chunk"
SOURCE = "paddle_tpu_torch/csrc/decode_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/decode_attention.py:605"

# kernel launches since the last reset (bumped only where the kernel is
# launched; the plain version never counts)
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_slab_chunk_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _shapes(q, k, v, qpos, num_heads):
    """(S, K, T, H, Hkv, dh) after checking every shape the kernel
    takes; raises ValueError otherwise."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{NAME}: want q [S, K, D], k/v [S, T, Dkv]; got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    s, kk, d = q.shape
    t, dkv = k.shape[1], k.shape[2]
    if k.shape[0] != s or tuple(qpos.shape) != (s, kk) or kk < 1 or t < 1:
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"qpos {tuple(qpos.shape)} do not describe S rows "
                         "of K >= 1 lanes over a T >= 1 slab")
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"{NAME}: num_heads={num_heads} does not divide "
                         f"D={d}")
    dh = d // num_heads
    _check.head_dim(NAME, dh)
    if dkv % dh or num_heads % (dkv // dh):
        raise ValueError(f"{NAME}: Dkv={dkv} is not a whole number of "
                         f"KV heads dividing {num_heads} query heads")
    return s, kk, t, num_heads, dkv // dh, dh


def decode_attention_slab_chunk_plain(q, k, v, qpos, num_heads):
    """The contract written as masked softmax attention: lane (r, i)
    attends row r's stripe at cols <= qpos[r, i]; rows whose lanes all
    repeat lane 0's position (a decode row) give exact zeros on lanes
    1..K-1, as the kernel's fast path writes them."""
    s, kk, t, h, hkv, dh = _shapes(q, k, v, qpos, num_heads)
    qh = q.reshape(s, kk, h, dh).transpose(1, 2)
    kh = attn_ops.repeat_kv_heads(k.reshape(s, t, hkv, dh).transpose(1, 2),
                                  h)
    vh = attn_ops.repeat_kv_heads(v.reshape(s, t, hkv, dh).transpose(1, 2),
                                  h)
    cols = torch.arange(t, device=q.device)
    mask = cols[None, None, :] <= qpos[:, :, None].long()      # [S, K, T]
    out = attn_ops.dot_product_attention(qh, kh, vh, mask=mask[:, None])
    out = out.transpose(1, 2).reshape(s, kk, h * dh)
    decode_row = qpos[:, kk - 1] == qpos[:, 0]
    live = (torch.arange(kk, device=q.device)[None, :] == 0) \
        | ~decode_row[:, None]
    return torch.where(live[..., None], out, torch.zeros_like(out))


def decode_attention_slab_chunk(q, k, v, qpos, num_heads):
    """q [S, K, D] f32, k/v [S, T, Dkv] f32 (the cache, already holding
    this step's writes), qpos [S, K] int32 per-lane positions
    (non-decreasing per row) -> [S, K, D].  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    global launches
    f32, i32 = torch.float32, torch.int32
    dev = _check.tensors(NAME, {"q": f32, "k": f32, "v": f32, "qpos": i32},
                         q=q, k=k, v=v, qpos=qpos)
    s, kk, t, h, hkv, dh = _shapes(q, k, v, qpos, num_heads)
    if dev.type == "cpu":
        return decode_attention_slab_chunk_plain(q, k, v, qpos, num_heads)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
                  out.data_ptr(), s, kk, t, h, hkv, dh,
                  1.0 / math.sqrt(dh), stream)
    _build.check(NAME, rc)
    launches += 1
    return out
