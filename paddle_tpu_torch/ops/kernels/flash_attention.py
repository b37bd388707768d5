"""Flash attention forward — the batched causal pass of
``models/transformer.lm_prefill``.

Port of the forward of ``paddle_tpu/ops/pallas/flash_attention.py ::
flash_attention`` ([B, H, T, dh] in and out).  The kernel is
``csrc/flash_attention.cu``; ``flash_attention_plain`` is its plain
PyTorch version (materialized masked attention plus logsumexp), which
the CPU takes and which ``chip_smoke.py`` holds the kernel against.
Unlike the TPU wrapper, no shape falls back to a masked path: the kernel
masks ragged edges itself and raises on what it does not take.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops.kernels import _build, _check

NAME = "flash_attention"
SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:144"

# kernel launches since the last reset (bumped only where the kernel is
# launched; the plain version never counts)
launches = 0

_NEG = -1e30
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{NAME}: want q [B, H, Tq, D], k/v [B, H, Tk, D];"
                         f" got q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tq < 1 or tk < 1:
        raise ValueError(f"{NAME}: empty sequence (Tq={tq}, Tk={tk})")
    if causal and tq != tk:
        raise ValueError(f"{NAME}: causal attention needs Tq == Tk (aligned "
                         f"starts); got Tq={tq}, Tk={tk}")
    _check.head_dim(NAME, d)
    return b, h, tq, tk, d


def flash_attention_plain(q, k, v, scale=None, causal=False):
    """(o [B, H, Tq, D], lse [B, H, Tq]): softmax(q k^T * scale) v
    materialized, masked at -1e30 above the diagonal when causal."""
    _shapes(q, k, v, causal)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t = q.shape[2]
        cm = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm, logits, logits.new_tensor(_NEG))
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    return o, lse


def flash_attention_fwd(q, k, v, scale=None, causal=False):
    """(o [B, H, Tq, D], lse [B, H, Tq] f32) — the forward with the
    log-sum-exp a backward needs.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    global launches
    f32 = torch.float32
    dev = _check.tensors(NAME, {"q": f32, "k": f32, "v": f32},
                         q=q, k=k, v=v)
    b, h, tq, tk, d = _shapes(q, k, v, causal)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b * h, tq, tk, d, scale, int(causal),
                  stream)
    _build.check(NAME, rc)
    launches += 1
    return o, lse


def flash_attention(q, k, v, scale=None, causal=False):
    """q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D] (forward)."""
    return flash_attention_fwd(q, k, v, scale, causal)[0]
