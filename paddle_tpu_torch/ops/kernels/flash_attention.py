"""Flash attention — the batched causal pass of
``models/transformer.lm_prefill`` and every attention of the training
path (``ops/attention.dot_product_attention``'s flash route).

Port of the kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:

* ``flash_attention`` (the forward; [B, H, T, dh] in and out) over a
  float32 cache;
* its backward, ``flash_attention_bwd``: the dK/dV and the dQ kernel of
  ``_bwd``, with ``FlashAttention`` (a ``torch.autograd.Function``) the
  counterpart of ``_flash_bhtd``'s custom_vjp;
* ``flash_attention_quant``: the same pass over the just-quantized int8
  cache (``lm_prefill(kv_dtype="int8")``), q [B, T, D] flat, k/v
  [B, T, Dkv] int8 with per-(position, KV head) f32 scales, grouped KV
  heads read in the kernel.

The two forwards are one template in ``csrc/flash_attention.cu``, the
backward two more kernels there; ``flash_attention_plain`` /
``flash_attention_bwd_plain`` / ``flash_attention_quant_plain`` are their
plain PyTorch versions (materialized masked attention), which the CPU
takes and which ``chip_smoke.py`` holds the kernels against.  Unlike the
TPU wrappers, no shape falls back to a masked path: the kernels mask
ragged edges themselves and raise on what they do not take.

Operand dtypes, as JAX's kernels take them: q, k and v each float32,
bf16 or float16 (and q bf16 or float16 over the int8 cache); o, dq, dk
and dv in their operand's dtype, lse and the backward's delta float32.
Each kernel widens a bf16 or float16 operand on load and computes as
its float32 instance; every combination with a low-precision operand
launches the kernel's one low-precision instance (the ``_low`` C
entries, the operands' dtypes passed as bits), and the plain versions
widen and round alike.

The kernels are compiled at head dims 16, 32, 64 and 128, and at the
wide 256, 384 and 512 (their own tiling: the head dim split across a
CTA's warps).  The wrappers take any other head dim up to 128, as the
TPU kernel does, by zero-padding q, k, v (and o, do) to the next
compiled width and slicing the results back: zero columns add nothing
to q k^T, and the padded columns of o, dq, dk and dv are zero.  The
scale stays 1/sqrt of the true head dim.  Any other head dim raises;
``ops/attention.dot_product_attention`` sends those to its dense path.
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
NAME_BWD_DKV = "flash_attention_bwd_dkv"
REPLACES_BWD_DKV = "paddle_tpu/ops/pallas/flash_attention.py:276"
NAME_BWD_DQ = "flash_attention_bwd_dq"
REPLACES_BWD_DQ = "paddle_tpu/ops/pallas/flash_attention.py:304"

# kernel launches since the last reset (bumped only where the kernel is
# launched; the plain versions never count)
launches = 0
launches_quant = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0
# launches of the low-precision instances since the last reset, by row
# name
# ("<NAME>[<operands>]", ``_check.operand_suffix``); the counters above
# count every instance's launches
launches_low = {}

_NEG = -1e30
# C entry -> (pointer args, int args before the float scale); each entry
# then takes (float scale, int causal, cudaStream_t)
_SIGNATURES = {"flash_attention_fwd_f32": (5, 4),
               "flash_attention_fwd_low": (5, 5),
               "flash_attention_quant_i8": (6, 6),
               "flash_attention_quant_i8_low": (6, 7),
               "flash_attention_bwd_dkv_f32": (8, 4),
               "flash_attention_bwd_dkv_low": (8, 5),
               "flash_attention_bwd_dq_f32": (8, 4),
               "flash_attention_bwd_dq_low": (8, 5)}
_F32 = torch.float32
_FLOATS = (_F32, torch.bfloat16, torch.float16)


def _dts(q, k=None, v=None):
    """The dtype bits of (q, k, v) (csrc/flash_attention.cu: kQ, kK, kV
    for bf16 q with o, do and dq, k with dk, v with dv; the same bits
    shifted by kHalf for float16): 0 for all float32."""
    return _check.dtype_bits(q, k, v)


def _entry(name):
    return _build.entry("flash_attention", name, *_SIGNATURES[name],
                        ctypes.c_float, ctypes.c_int)


def padded_head_dim(dh):
    """The compiled head dim the kernels run ``dh`` at: the smallest of
    ``_check.HEAD_DIMS`` at or above it, or ``dh`` itself where it is one
    of ``_check.WIDE_HEAD_DIMS``.  Raises at any other dh."""
    for width in _check.HEAD_DIMS:
        if dh <= width:
            return width
    if dh in _check.WIDE_HEAD_DIMS:
        return dh
    raise ValueError(f"{NAME}: head dim {dh} is not one the kernels take "
                     f"(any up to {_check.HEAD_DIMS[-1]}, or one of "
                     f"{_check.WIDE_HEAD_DIMS})")


def _pad(x, width):
    """x [..., dh] zero-padded to [..., width]."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


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
    padded_head_dim(d)
    return b, h, tq, tk, d


def flash_attention_plain(q, k, v, scale=None, causal=False):
    """(o [B, H, Tq, D] in q's dtype, lse [B, H, Tq] float32):
    softmax(q k^T * scale) v materialized on the widened operands,
    masked at -1e30 above the diagonal when causal."""
    _shapes(q, k, v, causal)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dtype, q, k, v = q.dtype, q.float(), k.float(), v.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t = q.shape[2]
        cm = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm, logits, logits.new_tensor(_NEG))
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    return o.to(dtype), lse


def flash_attention_fwd(q, k, v, scale=None, causal=False):
    """(o [B, H, Tq, D], lse [B, H, Tq] f32) — the forward with the
    log-sum-exp a backward needs.  CUDA tensors launch the kernel; CPU
    tensors take the plain version; a head dim between the compiled ones
    is padded to the next on both."""
    global launches
    dev = _check.tensors(NAME, {"q": _FLOATS, "k": _FLOATS, "v": _FLOATS},
                         q=q, k=k, v=v)
    b, h, tq, tk, d = _shapes(q, k, v, causal)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    width = padded_head_dim(d)
    if width != d:
        o, lse = flash_attention_fwd(*(_pad(x, width) for x in (q, k, v)),
                                     scale, causal)
        return o[..., :d].contiguous(), lse
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=_F32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dts = _dts(q, k, v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d)
    if dts:
        rc = _entry("flash_attention_fwd_low")(*args, dts, scale,
                                                int(causal), stream)
    else:
        rc = _entry("flash_attention_fwd_f32")(*args, scale, int(causal),
                                               stream)
    _build.check(NAME, rc)
    launches += 1
    _count_low(NAME, q=q, k=k, v=v)
    return o, lse


def _count_low(name, **operands):
    """One launch of ``name``'s low-precision instance for these
    operands, unless they are all float32 (``launches_low``)."""
    _check.count_low(launches_low, name, _check.operand_suffix(**operands))


def flash_attention(q, k, v, scale=None, causal=False):
    """q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D] (forward)."""
    return flash_attention_fwd(q, k, v, scale, causal)[0]


# ------------------------------------------------------------- backward

def _bwd_shapes(q, k, v, o, lse, do, causal):
    b, h, tq, tk, d = _shapes(q, k, v, causal)
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (b, h, tq):
        raise ValueError(f"{NAME}: backward wants o/do {tuple(q.shape)} and "
                         f"lse {(b, h, tq)}; got o {tuple(o.shape)} do "
                         f"{tuple(do.shape)} lse {tuple(lse.shape)}")
    return b, h, tq, tk, d


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale=None,
                              causal=False):
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, its
    log-sum-exp ``lse`` [B, H, Tq] and the output gradient ``do``: the
    TPU ``_bwd`` and its two kernel bodies line for line, materialized —
    delta = rowsum(do o); p = exp(s - lse) from the masked scores; dv =
    p^T do; dp = do v^T; ds = p (dp - delta) scale; dk = ds^T q; dq =
    ds k, on the widened operands, each gradient rounded to its
    operand's dtype."""
    _bwd_shapes(q, k, v, o, lse, do, causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dtypes = q.dtype, k.dtype, v.dtype
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    delta = (do * o).sum(-1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t = q.shape[2]
        cm = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm, s, s.new_tensor(_NEG))
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    return dq.to(dtypes[0]), dk.to(dtypes[1]), dv.to(dtypes[2])


def flash_attention_bwd(q, k, v, o, lse, do, scale=None, causal=False):
    """(dq, dk, dv): the backward of ``flash_attention_fwd``.  CUDA
    tensors: the dQ kernel, which also writes delta = rowsum(do o), then
    the dK/dV kernel, which reads it.  CPU tensors take the plain
    version; a head dim between the compiled ones is padded to the next
    on both."""
    dev = _check.tensors(NAME_BWD_DKV, {"q": _FLOATS, "k": _FLOATS,
                                        "v": _FLOATS, "o": _FLOATS,
                                        "lse": _F32, "do": _FLOATS},
                         q=q, k=k, v=v, o=o, lse=lse, do=do)
    _check.same_dtype(NAME_BWD_DKV, "q", q, o=o, do=do)
    _bwd_shapes(q, k, v, o, lse, do, causal)
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    width = padded_head_dim(d)
    if width != d:
        qp, kp, vp, op, dop = (_pad(x, width) for x in (q, k, v, o, do))
        return tuple(g[..., :d].contiguous() for g in flash_attention_bwd(
            qp, kp, vp, op, lse, dop, scale, causal))
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal)
    dq, delta = bwd_dq_kernel(q, k, v, o, lse, do, scale, causal)
    dk, dv = bwd_dkv_kernel(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def bwd_dkv_kernel(q, k, v, do, lse, delta, scale, causal):
    """One launch of the dK/dV kernel on CUDA tensors already checked by
    ``flash_attention_bwd``; ``delta`` is the dQ kernel's -> (dk, dv)."""
    global launches_bwd_dkv
    b, h, tq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = [*(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)),
            b * h, tq, k.shape[2], d]
    dts = _dts(q, k, v)
    entry = ("flash_attention_bwd_dkv_low" if dts
             else "flash_attention_bwd_dkv_f32")
    rc = _entry(entry)(*args, *([dts] if dts else []), scale, int(causal),
                       _stream(q))
    _build.check(NAME_BWD_DKV, rc)
    launches_bwd_dkv += 1
    _count_low(NAME_BWD_DKV, q=q, k=k, v=v)
    return dk, dv


def bwd_dq_kernel(q, k, v, o, lse, do, scale, causal):
    """One launch of the dQ kernel on CUDA tensors already checked by
    ``flash_attention_bwd`` -> (dq, delta [B, H, Tq] = rowsum(do o))."""
    global launches_bwd_dq
    b, h, tq, d = q.shape
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    args = [*(x.data_ptr() for x in (q, k, v, do, o, lse, delta, dq)),
            b * h, tq, k.shape[2], d]
    dts = _dts(q, k, v)
    entry = ("flash_attention_bwd_dq_low" if dts
             else "flash_attention_bwd_dq_f32")
    rc = _entry(entry)(*args, *([dts] if dts else []), scale, int(causal),
                       _stream(q))
    _build.check(NAME_BWD_DQ, rc)
    launches_bwd_dq += 1
    _count_low(NAME_BWD_DQ, q=q, k=k, v=v)
    return dq, delta


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward kernels: the counterpart of
    the TPU ``_flash_bhtd`` custom_vjp.  ``FlashAttention.apply(q, k, v,
    scale, causal)``, q [B, H, Tq, D], k/v [B, H, Tk, D] in any strides
    (the training path hands in transposed views; they are made
    contiguous here, the wrappers' checks stay as they are).  The
    forward saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None, causal=False):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


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
    padded_head_dim(dh)
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


def prefill_quant_covers(d, dkv, num_heads):
    """JAX's ``prefill_quant_covers`` (``flash_attention.py:585``) on
    ``lm_prefill``'s head widths: D and Dkv split into grouped heads of
    a width the kernel takes (up to 128, or 256, 384, 512; JAX takes
    every multiple of 128).  Where it fails, ``lm_prefill`` dequantizes
    the just-written codes and attends on the float32 route, as the
    reference does where its rule fails: the same function, which above
    512 is the dense path.  The port's kernel takes any Tq == Tk, so the
    reference's block rule on T does not apply."""
    if num_heads < 1 or d % num_heads:
        return False
    dh = d // num_heads
    if dkv % dh or num_heads % (dkv // dh):
        return False
    return _check.flash_head_dim(dh)


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
    """Int8-K/V flash prefill: q [B, Tq, D] float32, bf16 or float16 (the
    flat projection), k/v [B, Tk, Dkv] int8 (the cache layout), kscale/vscale
    [B, Tk, Hkv] f32 -> [B, H, Tq, dh] in q's dtype.  Query head h reads KV head h // (H / Hkv) in
    the kernel.  CUDA tensors launch the kernel; CPU tensors take the
    plain version; a head dim between the compiled ones is padded to the
    next on both (each head's codes and query zero-extended: zero codes
    dequantize to the float32 route's zero padding, bit for bit)."""
    global launches_quant
    b, tq, tk, h, hkv, dh = _quant_shapes(q, k, v, kscale, vscale,
                                          num_heads, causal)
    dev = _check.tensors(NAME_QUANT, {"q": _FLOATS, "k": torch.int8,
                                      "v": torch.int8, "kscale": _F32,
                                      "vscale": _F32},
                         q=q, k=k, v=v, kscale=kscale, vscale=vscale)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    width = padded_head_dim(dh)
    if width != dh:
        def heads(x, t, n):
            return _pad(x.reshape(b, t, n, dh), width).reshape(b, t,
                                                               n * width)
        o = flash_attention_quant(heads(q, tq, h), heads(k, tk, hkv),
                                  heads(v, tk, hkv), kscale, vscale,
                                  num_heads, scale, causal)
        return o[..., :dh].contiguous()
    if dev.type == "cpu":
        return flash_attention_quant_plain(q, k, v, kscale, vscale,
                                           num_heads, scale, causal)
    o = torch.empty((b, h, tq, dh), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kscale.data_ptr(),
            vscale.data_ptr(), o.data_ptr(), b, h, hkv, tq, tk, dh)
    if q.dtype == _F32:
        rc = _entry("flash_attention_quant_i8")(*args, scale, int(causal),
                                                stream)
    else:
        rc = _entry("flash_attention_quant_i8_low")(*args, _dts(q), scale,
                                                    int(causal), stream)
    _build.check(NAME_QUANT, rc)
    launches_quant += 1
    _count_low(NAME_QUANT, q=q)
    return o
