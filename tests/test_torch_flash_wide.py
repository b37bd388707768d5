"""The flash route at the wide head dims 256, 384 and 512 on the CPU,
against the JAX package's ``flash_attention`` and
``flash_attention_quant``, run as the JAX tests run them on the CPU (the
Pallas kernels in interpret mode).

The port's kernels compile these widths (``csrc/flash_attention.cu``,
the ``_wide`` kernels; ``chip_smoke.py`` holds them against the plain
versions on the card); on CPU tensors the wrappers take the plain
versions, so these tests hold those and the route: the forward's o
through ``dot_product_attention`` (which must take ``FlashAttention``),
dq, dk and dv through ``FlashAttention``, ``flash_attention_quant`` at
dh 256, and dh 640 (a multiple of 128 the kernels do not compile), which
the port's route sends to its dense path and JAX's kernel computes.

Tolerance: 1e-4 of each output's largest entry, absolute -- float32 on
both sides, blocked sums against materialized ones over 128 keys of
dot products of up to 640 terms.
"""

import functools
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.quant import kv as jax_kvq
from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.kernels import flash_attention as fk

# the ops.pallas package re-exports the flash_attention FUNCTION under the
# submodule's name
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

REL = 1e-4
T = 128


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _case(dh, causal):
    """Seeded q, k, v, do [1, 2, T, dh] and JAX's (o, (dq, dk, dv))."""
    rng = np.random.RandomState(dh + causal)
    q, k, v, do = (rng.standard_normal((1, 2, T, dh)).astype(np.float32)
                   for _ in range(4))

    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, causal=causal, interpret=True)

    o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return (q, k, v, do), (np.asarray(o), [np.asarray(g) for g in grads])


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts FlashAttention.apply calls (the CPU counters cannot)."""
    calls = []
    real = fk.FlashAttention.apply

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(fk.FlashAttention, "apply", counted)
    return calls


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [256, 384, 512])
def test_forward_route_matches_jax(flash_calls, dh, causal):
    (q, k, v, _), (want, _) = _case(dh, causal)
    assert fk.padded_head_dim(dh) == dh
    got = attn.dot_product_attention(*map(torch.tensor, (q, k, v)),
                                     causal=causal)
    assert len(flash_calls) == 1
    _close(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [256, 384, 512])
def test_gradients_match_jax(dh, causal):
    (q, k, v, do), (want_o, want) = _case(dh, causal)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fk.FlashAttention.apply(*leaves, None, causal)
    o.backward(torch.tensor(do))
    _close(o.detach().numpy(), want_o)
    for x, w in zip(leaves, want):
        _close(x.grad.numpy(), w)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_640_takes_the_dense_path_as_jax(flash_calls, causal):
    """dh 640: JAX's kernel takes it (lane-tileable), the port's kernels
    are not compiled that wide, so its route takes the dense path: the
    same function."""
    (q, k, v, do), (want_o, want) = _case(640, causal)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = attn.dot_product_attention(*leaves, causal=causal, use_flash=True)
    o.backward(torch.tensor(do))
    assert not flash_calls
    _close(o.detach().numpy(), want_o)
    for x, w in zip(leaves, want):
        _close(x.grad.numpy(), w)
    with pytest.raises(ValueError, match="not one the kernels take"):
        fk.flash_attention_fwd(*map(torch.tensor, (q, k, v)))


@pytest.mark.parametrize("hkv", [2, 1])
def test_flash_attention_quant_at_dh_256_matches_jax(hkv):
    """The int8 prefill at dh 256 (GQA in the kernel at Hkv 1) against
    JAX's interpret-mode kernel on the same codes and scales; the port's
    route admits the width and the output equals its float32 route on
    the dequantized, repeated heads bit for bit (the plain versions)."""
    b, h, dh = 2, 2, 256
    rng = np.random.RandomState(17 + hkv)
    q = rng.standard_normal((b, T, h * dh)).astype(np.float32)
    (kc, ks), (vc, vs) = (
        (np.array(a) for a in jax_kvq.quantize_heads(jnp.asarray(
            rng.standard_normal((b, T, hkv * dh)).astype(np.float32)), hkv))
        for _ in range(2))
    want = np.asarray(jax_fa.flash_attention_quant(
        *map(jnp.asarray, (q, kc, vc, ks, vs)), h, interpret=True))
    assert fk.prefill_quant_covers(h * dh, hkv * dh, h)
    tt = torch.tensor
    got = fk.flash_attention_quant(tt(q), tt(kc), tt(vc), tt(ks), tt(vs), h)
    _close(got.numpy(), want)
    twin = fk.flash_attention_quant_plain(tt(q), tt(kc), tt(vc), tt(ks),
                                          tt(vs), h)
    assert torch.equal(got, twin)


def test_prefill_quant_covers_follows_the_compiled_widths():
    """The int8 prefill's rule: the kernels' widths (up to 128, 256, 384,
    512); above, lm_prefill dequantizes onto the float32 route."""
    for dh, want in ((96, True), (128, True), (160, False), (256, True),
                     (384, True), (512, True), (640, False)):
        assert fk.prefill_quant_covers(2 * dh, dh, 2) == want, dh
        assert _check.flash_head_dim(dh) == want, dh
