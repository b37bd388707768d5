"""Int8 KV cache: per-(position, KV head) symmetric scales — a copy of
``paddle_tpu/quant/kv.py`` in PyTorch.

Each written position and KV head gets its own float32 scale ``s =
amax / 127`` (0 for an all-zero head), and the codes are ``clip(round(x
/ s), -127, 127)`` as int8, rounding half to even (``torch.round`` rounds
as ``jnp.round`` does).  The scale is computed from the value being
written, so quantization is a pure function of the written K/V: a
prefill, a chunked step and a re-seat that write the same K/V write the
same codes.  The ``[..., Hkv]`` sidecar costs ``4 / head_dim`` of the
int8 data, so K + V stream at ``1/4 + 1/head_dim`` of the float32 bytes
(``kv_bytes_per_position``).
"""

import numpy as np
import torch

KV_DTYPES = ("float32", "int8")

# Quality budget, the JAX package's committed numbers: an int8-KV greedy
# stream matches its float32 twin for at least GREEDY_PREFIX_MIN tokens on
# the seeded test trunks (GREEDY_PREFIX_MIN_FULL with int8 weights too),
# and the max |logit error| of a quantized prefill against its float32
# twin stays under LOGIT_ERR_BUDGET.
GREEDY_PREFIX_MIN = 16
GREEDY_PREFIX_MIN_FULL = 4
LOGIT_ERR_BUDGET = 0.06


def _split_heads(x, hkv):
    dkv = x.shape[-1]
    if hkv < 1 or dkv % hkv:
        raise ValueError(f"Dkv={dkv} not divisible by Hkv={hkv}")
    return x.reshape(x.shape[:-1] + (hkv, dkv // hkv))


def quantize_heads(x, hkv):
    """``x`` [..., Dkv] float32 -> ``(codes int8 [..., Dkv], scales
    float32 [..., Hkv])``, one scale per (leading index, KV head)."""
    xh = _split_heads(x, hkv)
    s = xh.abs().amax(dim=-1) / 127.0
    safe = torch.where(s > 0, s, torch.ones_like(s))[..., None]
    q = torch.clamp(torch.round(xh / safe), -127, 127).to(torch.int8)
    return q.reshape(x.shape), s.to(torch.float32)


def dequantize_heads(q, s):
    """Widen ``q`` [..., Dkv] int8 by its scales ``s`` [..., Hkv] ->
    float32 [..., Dkv]: one multiply per value, the product the int8
    kernels form in registers."""
    qh = _split_heads(q.to(torch.float32), s.shape[-1])
    return (qh * s[..., None]).reshape(q.shape)


def greedy_prefix_len(a, b):
    """Length of the common leading run of two token streams (the
    comparison ``GREEDY_PREFIX_MIN`` is defined over)."""
    n = 0
    if a is None or b is None:
        return 0
    for x, y in zip(a, b):
        if int(x) != int(y):
            break
        n += 1
    return n


def logit_err(ref_logits, logits, lens=None):
    """Per-stream max |logit error| of a quantized forward against its
    float32 twin (the comparison ``LOGIT_ERR_BUDGET`` is defined over).
    ``ref_logits``/``logits``: [..., T, vocab] (tensors or arrays);
    ``lens`` [...]: valid positions per stream, padded tail positions
    masked out.  Returns one value per leading index as an ndarray."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)

    err = np.abs(host(ref_logits) - host(logits)).max(axis=-1)
    if lens is not None:
        t = err.shape[-1]
        valid = np.arange(t) < np.asarray(lens)[..., None]
        err = np.where(valid, err, 0.0)
    return err.max(axis=-1)


def kv_bytes_per_position(dkv, hkv, kv_dtype):
    """Device bytes one cached position costs (K and V, sidecar
    included)."""
    if kv_dtype == "int8":
        return 2 * dkv * 1 + 2 * hkv * 4
    return 2 * dkv * 4
