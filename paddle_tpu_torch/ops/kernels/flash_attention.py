"""Flash attention forward — the batched causal pass of
``models/transformer.lm_prefill``.

Port of two kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:

* ``flash_attention`` (the forward; [B, H, T, dh] in and out) over a
  float32 cache;
* ``flash_attention_quant``: the same pass over the just-quantized int8
  cache (``lm_prefill(kv_dtype="int8")``), q [B, T, D] flat, k/v
  [B, T, Dkv] int8 with per-(position, KV head) f32 scales, grouped KV
  heads read in the kernel.

Both are one template in ``csrc/flash_attention.cu``;
``flash_attention_plain`` / ``flash_attention_quant_plain`` are their
plain PyTorch versions (materialized masked attention), which the CPU
takes and which ``chip_smoke.py`` holds the kernels against.  Unlike the
TPU wrappers, no shape falls back to a masked path: the kernels mask
ragged edges themselves and raise on what they do not take.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops.kernels import _build, _check
from paddle_tpu_torch.quant.kv import dequantize_heads

NAME = "flash_attention"
SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:144"
NAME_QUANT = "flash_attention_quant"
REPLACES_QUANT = "paddle_tpu/ops/pallas/flash_attention.py:554"

# kernel launches since the last reset (bumped only where the kernel is
# launched; the plain versions never count)
launches = 0
launches_quant = 0

_NEG = -1e30
# C entry -> (pointer args, int args before the float scale); each entry
# then takes (float scale, int causal, cudaStream_t)
_SIGNATURES = {"flash_attention_fwd_f32": (5, 4),
               "flash_attention_quant_i8": (6, 6)}
_entries = {}


def _entry(name):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), name)
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


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
    rc = _entry("flash_attention_fwd_f32")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, tq, tk, d, scale, int(causal), stream)
    _build.check(NAME, rc)
    launches += 1
    return o, lse


def flash_attention(q, k, v, scale=None, causal=False):
    """q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D] (forward)."""
    return flash_attention_fwd(q, k, v, scale, causal)[0]


# ------------------------------------------------------------- int8 K/V

def _quant_shapes(q, k, v, kscale, vscale, num_heads, causal):
    """(B, Tq, Tk, H, Hkv, dh) for q [B, Tq, D], k/v [B, Tk, Dkv] int8,
    kscale/vscale [B, Tk, Hkv]; raises ValueError on anything else."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0]:
        raise ValueError(f"{NAME_QUANT}: want q [B, Tq, D], k/v [B, Tk, "
                         f"Dkv]; got q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, tq, d = q.shape
    tk, dkv = k.shape[1], k.shape[2]
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"{NAME_QUANT}: num_heads={num_heads} does not "
                         f"divide D={d}")
    dh = d // num_heads
    _check.head_dim(NAME_QUANT, dh)
    if dkv % dh or num_heads % (dkv // dh):
        raise ValueError(f"{NAME_QUANT}: Dkv={dkv} is not a whole number of "
                         f"KV heads dividing {num_heads} query heads")
    hkv = dkv // dh
    if kscale is None or vscale is None:
        raise ValueError(f"{NAME_QUANT}: scale sidecars required")
    want = (b, tk, hkv)
    if tuple(kscale.shape) != want or tuple(vscale.shape) != want:
        raise ValueError(f"{NAME_QUANT}: scale sidecars must be {want}, got "
                         f"{tuple(kscale.shape)}/{tuple(vscale.shape)}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{NAME_QUANT}: k/v must be int8, got "
                         f"{k.dtype}/{v.dtype}")
    if tq < 1 or tk < 1:
        raise ValueError(f"{NAME_QUANT}: empty sequence (Tq={tq}, Tk={tk})")
    if causal and tq != tk:
        raise ValueError(f"{NAME_QUANT}: causal attention needs Tq == Tk "
                         f"(aligned starts); got Tq={tq}, Tk={tk}")
    return b, tq, tk, num_heads, hkv, dh


def flash_attention_quant_plain(q, k, v, kscale, vscale, num_heads,
                                scale=None, causal=True):
    """The int8 cache dequantized (``dequantize_heads``), its KV heads
    repeated to the query heads, then ``flash_attention_plain`` ->
    [B, H, Tq, dh]."""
    b, tq, tk, h, hkv, dh = _quant_shapes(q, k, v, kscale, vscale,
                                          num_heads, causal)

    def heads(x, t, n):
        return x.reshape(b, t, n, dh).transpose(1, 2)

    kh = attn_ops.repeat_kv_heads(heads(dequantize_heads(k, kscale), tk,
                                        hkv), h)
    vh = attn_ops.repeat_kv_heads(heads(dequantize_heads(v, vscale), tk,
                                        hkv), h)
    return flash_attention_plain(heads(q, tq, h), kh, vh, scale, causal)[0]


def flash_attention_quant(q, k, v, kscale, vscale, num_heads, scale=None,
                          causal=True):
    """Int8-K/V flash prefill: q [B, Tq, D] f32 (the flat projection),
    k/v [B, Tk, Dkv] int8 (the cache layout), kscale/vscale [B, Tk, Hkv]
    f32 -> [B, H, Tq, dh].  Query head h reads KV head h // (H / Hkv) in
    the kernel.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    global launches_quant
    f32 = torch.float32
    b, tq, tk, h, hkv, dh = _quant_shapes(q, k, v, kscale, vscale,
                                          num_heads, causal)
    dev = _check.tensors(NAME_QUANT, {"q": f32, "k": torch.int8,
                                      "v": torch.int8, "kscale": f32,
                                      "vscale": f32},
                         q=q, k=k, v=v, kscale=kscale, vscale=vscale)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    if dev.type == "cpu":
        return flash_attention_quant_plain(q, k, v, kscale, vscale,
                                           num_heads, scale, causal)
    o = torch.empty((b, h, tq, dh), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _entry("flash_attention_quant_i8")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kscale.data_ptr(),
        vscale.data_ptr(), o.data_ptr(), b, h, hkv, tq, tk, dh, scale,
        int(causal), stream)
    _build.check(NAME_QUANT, rc)
    launches_quant += 1
    return o
