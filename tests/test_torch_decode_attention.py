"""Kernel A, ``decode_attention_slab_chunk``: the port's plain version
(what the CPU runs, and what the CUDA kernel is held to on the card)
against the JAX Pallas kernel in interpret mode, and against the JAX
masked path ``_attend`` on the live lanes; plus the wrapper's dispatch
and argument checks.

Tolerance 1e-5: float32 on both sides; the Pallas kernel runs a blocked
online softmax, the plain version a materialized one, so sums differ in
order by a few ulps on O(1) values.  The decode-row fast path's dead
lanes are exact zeros on both sides.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu_torch.ops.kernels import decode_attention as dk

TOL = 1e-5


def _qpos(kind_rows, kk):
    """[S, K] per-lane positions from (kind, start) rows, built the way
    the engine's ``_chunk_lanes`` builds them (inactive lanes repeat the
    last live lane's position)."""
    rows = []
    for live, start in kind_rows:
        li = np.minimum(np.arange(kk), live - 1)
        rows.append(start + li)
    return np.asarray(rows, np.int32)


CASES = {
    # name: (S rows as (live lanes, lane-0 position), K, T, H, Hkv, dh,
    #        JAX block_k)
    "mixed": ([(1, 9), (4, 0), (2, 17), (4, 20), (1, 0)], 4, 24, 2, 2, 16,
              None),
    "gqa": ([(1, 30), (3, 5), (4, 28), (2, 0)], 4, 32, 4, 2, 16, 8),
    "k1": ([(1, 0), (1, 7), (1, 15)], 1, 16, 2, 1, 16, None),
    "ragged_t": ([(8, 0), (5, 30), (1, 35), (8, 28)], 8, 36, 2, 2, 32, 8),
}


def _inputs(name, rng):
    rows, kk, t, h, hkv, dh, blk = CASES[name]
    s = len(rows)
    q = rng.standard_normal((s, kk, h * dh)).astype(np.float32)
    k = rng.standard_normal((s, t, hkv * dh)).astype(np.float32)
    v = rng.standard_normal((s, t, hkv * dh)).astype(np.float32)
    return q, k, v, _qpos(rows, kk), h, blk


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel_interpret_all_lanes(np_rng, name):
    q, k, v, qpos, h, blk = _inputs(name, np_rng)
    want = np.asarray(jax_dk.decode_attention_slab_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        h, block_k=blk, interpret=True))
    got = dk.decode_attention_slab_chunk_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(qpos), h).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the fast path: a decode row's lanes 1..K-1 are exact zeros, as the
    # TPU kernel's _finalize emits them
    decode = qpos[:, -1] == qpos[:, 0]
    assert not got[decode, 1:].any() and not want[decode, 1:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_attend_on_live_lanes(np_rng, name):
    q, k, v, qpos, h, _ = _inputs(name, np_rng)
    t = k.shape[1]
    mask = np.arange(t)[None, None, :] <= qpos[:, :, None]
    want = np.asarray(jax_tf._attend(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), h, jnp.asarray(mask)))
    got = dk.decode_attention_slab_chunk_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(qpos), h).numpy()
    live = (np.arange(qpos.shape[1])[None] == 0) \
        | (qpos[:, -1] != qpos[:, 0])[:, None]
    np.testing.assert_allclose(got[live], want[live], atol=TOL, rtol=TOL)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing(np_rng):
    q, k, v, qpos, h, _ = _inputs("gqa", np_rng)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v),
            torch.tensor(qpos), h)
    before = dk.launches
    out = dk.decode_attention_slab_chunk(*args)
    assert dk.launches == before
    np.testing.assert_array_equal(
        out.numpy(), dk.decode_attention_slab_chunk_plain(*args).numpy())


def _good(np_rng):
    q, k, v, qpos, h, _ = _inputs("mixed", np_rng)
    return dict(q=torch.tensor(q), k=torch.tensor(k), v=torch.tensor(v),
                qpos=torch.tensor(qpos), num_heads=h)


def _dh160(args):
    """One head of width 160: neither up to 128 nor a multiple of it."""
    s, kk, _ = args["q"].shape
    t = args["k"].shape[1]
    return dict(args, q=torch.zeros(s, kk, 160), k=torch.zeros(s, t, 160),
                v=torch.zeros(s, t, 160), num_heads=1)


@pytest.mark.parametrize("bad, exc", [
    (lambda a: dict(a, q=a["q"].double()), TypeError),
    # float16 K/V pass since C10; complex64, which JAX's kernel refuses
    # too, does not
    (lambda a: dict(a, k=a["k"].to(torch.complex64)), TypeError),
    (lambda a: dict(a, qpos=a["qpos"].long()), TypeError),
    (lambda a: dict(a, q=a["q"].transpose(0, 1).contiguous()
                    .transpose(0, 1)), ValueError),
    (lambda a: dict(a, qpos=a["qpos"][:, :2].contiguous()), ValueError),
    (lambda a: dict(a, v=a["v"][:, :-1].contiguous()), ValueError),
    (lambda a: dict(a, num_heads=3), ValueError),
    (lambda a: _dh160(a), ValueError),    # head dim 160: JAX refuses too
    (lambda a: dict(a, k=a["k"][:, :, :24].contiguous(),
                    v=a["v"][:, :, :24].contiguous()),
     ValueError),                                     # Dkv != whole heads
])
def test_bad_arguments_raise(np_rng, bad, exc):
    with pytest.raises(exc):
        dk.decode_attention_slab_chunk(**bad(_good(np_rng)))
