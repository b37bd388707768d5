"""The flash route at head dims between the compiled ones, and above
128: ``FlashAttention`` and ``ops/attention.dot_product_attention``
against JAX's ``flash_attention``, run as the JAX tests run it on the
CPU (the Pallas kernels in interpret mode, 32-row blocks).

The port's kernels are compiled at head dims 16, 32, 64 and 128 (and
256, 384, 512); the TPU kernel takes any dh up to 128.  The wrappers zero-pad q, k, v (and
o, do) to the next compiled width, keep the scale 1/sqrt(dh) of the true
width and slice o, dq, dk, dv back, on the CPU as on the card (where
``chip_smoke.py`` holds the kernels at dh 96 against the plain
version).  A dh above 128 that is not a multiple of 128 takes the dense
path in JAX's ``flash_attention`` and in the port's route alike.

Tolerance 1e-5 absolute and relative: float32 on both sides, blocked
sums against materialized ones over at most 64 terms of O(1) products.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.ops.kernels import flash_attention as fk

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = 1e-5


def _inputs(seed, tq, tk, dh):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((1, 2, t, dh)).astype(np.float32)
            for t in (tq, tk, tk, tq)]


def _jax(q, k, v, do, causal):
    """(o, (dq, dk, dv)) through JAX's flash_attention."""
    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, causal=causal, block_q=32,
                                      block_k=32, interpret=True)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port(fn, q, k, v, do):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fn(*leaves)
    o.backward(torch.tensor(do))
    return o.detach().numpy(), [x.grad.numpy() for x in leaves]


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dh", [24, 48, 96])
@pytest.mark.parametrize("causal, tq, tk", [(True, 64, 64),
                                            (False, 32, 64)])
def test_padded_head_dim_matches_jax_kernel(dh, causal, tq, tk):
    q, k, v, do = _inputs(dh + tq, tq, tk, dh)
    want_o, want = _jax(q, k, v, do, causal)
    for fn in (lambda q, k, v: fk.FlashAttention.apply(q, k, v, None,
                                                       causal),
               lambda q, k, v: attn.dot_product_attention(
                   q, k, v, causal=causal, use_flash=True)):
        o, grads = _port(fn, q, k, v, do)
        _close(o, want_o)
        for g, w in zip(grads, want):
            assert g.shape == w.shape
            _close(g, w)


def test_padded_head_dim_counts_no_launch_on_cpu():
    """The padded call takes the plain versions on CPU tensors, and its
    lse is the unpadded one's."""
    q, k, v, do = (torch.tensor(x) for x in _inputs(3, 16, 16, 48))
    before = (fk.launches, fk.launches_bwd_dq, fk.launches_bwd_dkv)
    o, lse = fk.flash_attention_fwd(q, k, v, causal=True)
    fk.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert (fk.launches, fk.launches_bwd_dq, fk.launches_bwd_dkv) == before
    want_o, want_lse = fk.flash_attention_plain(q, k, v, causal=True)
    _close(o.numpy(), want_o.numpy())
    _close(lse.numpy(), want_lse.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_wide_head_dim_takes_the_dense_path_as_jax(causal):
    """dh 160: JAX's flash_attention sends it to its masked path; the
    port's route, asked for flash, does the same."""
    q, k, v, do = _inputs(7, 32, 32, 160)
    want_o, want = _jax(q, k, v, do, causal)
    o, grads = _port(lambda q, k, v: attn.dot_product_attention(
        q, k, v, causal=causal, use_flash=True), q, k, v, do)
    _close(o, want_o)
    for g, w in zip(grads, want):
        _close(g, w)


def test_multiple_of_128_above_128_raises():
    """The kernels compile 256, 384 and 512 (tests/test_torch_flash_wide.py);
    what still raises is the kernel wrapper at a multiple of 128 above
    512, which dot_product_attention sends to its dense path instead."""
    wide = torch.zeros((1, 1, 128, 640))
    with pytest.raises(ValueError, match="not one the kernels take"):
        fk.flash_attention_fwd(wide, wide, wide)
    o = attn.dot_product_attention(wide, wide, wide)
    assert o.shape == wide.shape and not o.any()
