"""Kernel B8, the ``flash_attention`` backward: the port's plain version
(``flash_attention_bwd_plain`` — what the CPU runs, and what the dK/dV
and dQ kernels are held to on the card) and ``FlashAttention`` on CPU
tensors, against ``jax.vjp`` of the JAX Pallas kernel in interpret mode
with 16 x 16 blocks (so ``_bwd``'s two kernels stream over several q and
kv blocks), and against torch autograd of ``flash_attention_plain``;
the wrapper's dispatch and argument checks; and the flash route of
``ops/attention.dot_product_attention``.

Tolerance 1e-5 absolute and relative: float32 on both sides, blocked
sums against materialized ones over at most 64 terms of O(1) products
(a few ulps).
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as jax_attn
from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.ops.kernels import flash_attention as fk

# the ops.pallas package re-exports the flash_attention FUNCTION under the
# submodule's name
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = 1e-5
CASES = [(True, 32, 32, 16), (False, 32, 32, 16), (False, 32, 64, 32),
         (True, 64, 64, 32), (False, 64, 32, 16)]


def _inputs(rng, b, h, tq, tk, d):
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal):
    """(o, (dq, dk, dv)) through the Pallas forward and backward kernels
    in interpret mode."""
    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, causal=causal, block_q=16,
                                      block_k=16, interpret=True)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal, tq, tk, d", CASES)
def test_plain_backward_matches_pallas_backward(np_rng, causal, tq, tk, d):
    q, k, v, do = _inputs(np_rng, 2, 2, tq, tk, d)
    want_o, want = _jax_vjp(q, k, v, do, causal)
    tq_, tk_, tv_, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = fk.flash_attention_plain(tq_, tk_, tv_, causal=causal)
    _close(o, want_o)
    got = fk.flash_attention_bwd_plain(tq_, tk_, tv_, o, lse, tdo,
                                       causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal, tq, tk, d", CASES[:3])
def test_function_on_cpu_matches_pallas_backward(np_rng, causal, tq, tk, d):
    """FlashAttention.apply on transposed (non-contiguous) views, as the
    training path hands them in; the CPU takes both plain halves and
    the launch counters stay 0."""
    q, k, v, do = _inputs(np_rng, 2, 2, tq, tk, d)
    want_o, want = _jax_vjp(q, k, v, do, causal)
    leaves = [torch.tensor(a.transpose(0, 2, 1, 3).copy(),
                           requires_grad=True) for a in (q, k, v)]
    views = [x.transpose(1, 2) for x in leaves]
    assert not views[0].is_contiguous()
    before = (fk.launches, fk.launches_bwd_dkv, fk.launches_bwd_dq)
    o = fk.FlashAttention.apply(*views, None, causal)
    o.backward(torch.tensor(do))
    assert (fk.launches, fk.launches_bwd_dkv, fk.launches_bwd_dq) == before
    _close(o.detach(), want_o)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad.transpose(1, 2), w)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(np_rng, causal):
    q, k, v, do = (torch.tensor(a) for a in _inputs(np_rng, 2, 3, 24, 24,
                                                    32))
    scale = 0.3
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = fk.flash_attention_plain(*qkv, scale=scale, causal=causal)
    want = torch.autograd.grad(o, qkv, do)
    got = fk.flash_attention_bwd(q, k, v, o.detach(), lse.detach(), do,
                                 scale=scale, causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing(np_rng):
    q, k, v, do = (torch.tensor(a) for a in _inputs(np_rng, 1, 2, 9, 9, 16))
    o, lse = fk.flash_attention_fwd(q, k, v, causal=True)
    before = (fk.launches_bwd_dkv, fk.launches_bwd_dq)
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert (fk.launches_bwd_dkv, fk.launches_bwd_dq) == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_reset_launches_clears_the_backward_counters():
    from paddle_tpu_torch.ops import kernels
    fk.launches_bwd_dkv, fk.launches_bwd_dq = 3, 4
    kernels.reset_launches()
    assert (fk.launches_bwd_dkv, fk.launches_bwd_dq) == (0, 0)


@pytest.mark.parametrize("bad, exc", [
    (lambda a: dict(a, do=a["do"].double()), TypeError),
    (lambda a: dict(a, lse=a["lse"][:, :, :5].contiguous()), ValueError),
    (lambda a: dict(a, o=a["o"][:, :1].contiguous()), ValueError),
    (lambda a: {n: torch.cat([x] * 40, -1) if x.dim() == 4 else x
                for n, x in a.items()}, ValueError),
    (lambda a: dict(a, do=a["do"].transpose(2, 3).contiguous()
                    .transpose(2, 3)), ValueError),
    (lambda a: dict(a, k=a["k"][:, :, :5].contiguous(),
                    v=a["v"][:, :, :5].contiguous()), ValueError),
])
def test_bad_arguments_raise(np_rng, bad, exc):
    """dtype, lse/o shapes, a head dim the kernels do not take (640; any
    up to 128 is padded to a compiled one, 256, 384 and 512 compiled), a non-contiguous do (the
    wrapper does not copy; FlashAttention does), and causal with Tq !=
    Tk."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(np_rng, 1, 2, 9, 9, 16))
    o, lse = fk.flash_attention_plain(q, k, v, causal=True)
    args = bad(dict(q=q, k=k, v=v, o=o, lse=lse, do=do))
    with pytest.raises(exc):
        fk.flash_attention_bwd(**args, causal=True)


# ------------------------------------------- dot_product_attention route

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


@pytest.mark.parametrize("tq, tk, causal, key_mask, flash", [
    (128, 128, True, False, True), (128, 256, False, False, True),
    (128, 128, False, True, False), (64, 64, False, False, False),
    (128, 256, True, False, False)])
def test_flash_route_matches_jax_rule_and_dense_path(np_rng, flash_calls,
                                                     tq, tk, causal,
                                                     key_mask, flash):
    """use_flash=None takes the flash route exactly where the JAX rule
    would on a TPU; either route equals the JAX masked path."""
    q, k, v, _ = _inputs(np_rng, 1, 2, tq, tk, 16)
    km = None
    if key_mask:
        km = np.ones((1, tk), np.float32)
        km[0, tk - 5:] = 0.0
    want = np.asarray(jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        use_flash=False,
        key_mask=None if km is None else jnp.asarray(km)))
    got = attn.dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        key_mask=None if km is None else torch.tensor(km))
    assert bool(flash_calls) == flash
    _close(got, want)


def test_dot_product_attention_refusals(np_rng):
    q, k, v, _ = (torch.tensor(a) for a in _inputs(np_rng, 1, 1, 128, 128,
                                                   16))
    km = torch.ones((1, 128))
    with pytest.raises(ValueError, match="not both"):
        attn.dot_product_attention(q, k, v, mask=km[:, None, None] > 0,
                                   key_mask=km)
    with pytest.raises(ValueError, match="no mask support"):
        attn.dot_product_attention(q, k, v, key_mask=km, use_flash=True)
    # segment ids (packed rows) and chunked_attention run now, as in JAX;
    # what JAX refuses of them, the port refuses
    seg = torch.ones((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no mask support"):
        attn.dot_product_attention(q, k, v, q_segment_ids=seg,
                                   use_flash=True)
    with pytest.raises(ValueError, match="kv_segment_ids without"):
        attn.dot_product_attention(q, k, v, kv_segment_ids=seg)
    big = torch.zeros((1, 1, 2048, 16))
    with pytest.raises(ValueError, match="kv_segment_ids without"):
        attn.chunked_attention(big, big, big,
                               kv_segment_ids=torch.ones((1, 2048)))


@pytest.mark.parametrize("dh", [48, 80, 96, 112])
def test_flash_route_raises_at_head_dims_the_kernels_lack(np_rng,
                                                          flash_calls, dh):
    """What the flash route does at head dims the kernels lack.  They are
    compiled at 16, 32, 64 and 128 and at 256, 384 and 512; JAX's rule
    names no head dim and its TPU kernel takes any dh up to 128, so the
    route takes a dh between them padded to the next (equal to JAX's
    masked path).  The kernel wrappers raise at a width they do not
    compile (here 640), which the route sends to the dense path."""
    q, k, v, _ = _inputs(np_rng, 1, 1, 128, 128, dh)
    want = jax_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                          use_flash=False)
    got = attn.dot_product_attention(*map(torch.tensor, (q, k, v)))
    assert len(flash_calls) == 1
    _close(got, want)
    wide = torch.zeros((1, 1, 128, 640))
    with pytest.raises(ValueError, match="not one the kernels take"):
        fk.flash_attention_fwd(wide, wide, wide)
    attn.dot_product_attention(wide, wide, wide)
    assert len(flash_calls) == 1


@pytest.mark.parametrize("kind", ["mha", "gqa_rope", "cross_key_mask"])
def test_multi_head_attention_matches_jax(np_rng, flash_calls, kind):
    b, t, d, h = 2, 128, 64, 4      # dh 16
    hkv = 2 if kind == "gqa_rope" else h
    tk = 8 if kind == "cross_key_mask" else t
    xq = np_rng.standard_normal((b, t, d)).astype(np.float32)
    xkv = xq if tk == t else np_rng.standard_normal(
        (b, tk, d)).astype(np.float32)
    ws = [(np_rng.standard_normal(s) / np.sqrt(d)).astype(np.float32)
          for s in ((d, d), (d, hkv * d // h), (d, hkv * d // h), (d, d))]
    kw_j, kw_t = {}, {}
    if kind == "gqa_rope":
        pos = np.arange(t)
        kw_j["rope_positions"], kw_t["rope_positions"] = \
            jnp.asarray(pos), torch.tensor(pos)
    if kind == "cross_key_mask":
        km = np.asarray([[1] * 8, [1] * 5 + [0] * 3], np.float32)
        kw_j["key_mask"], kw_t["key_mask"] = jnp.asarray(km), torch.tensor(km)
    want = jax_attn.multi_head_attention(
        jnp.asarray(xq), jnp.asarray(xkv), *map(jnp.asarray, ws), h,
        causal=kind == "mha", **kw_j)
    got = attn.multi_head_attention(
        torch.tensor(xq), torch.tensor(xkv), *map(torch.tensor, ws), h,
        causal=kind == "mha", **kw_t)
    # self-attention at T 128 takes the flash route, the key mask does not
    assert bool(flash_calls) == (kind != "cross_key_mask")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_multi_head_attention_refusals(np_rng):
    x = torch.zeros((1, 4, 8))
    w = torch.zeros((8, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attn.multi_head_attention(x, x, w, w, w, w, 2, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attn.multi_head_attention(x, x, w, w, w, w, 2, zigzag=True)
    with pytest.raises(ValueError, match="multiple of head dim"):
        attn.multi_head_attention(x, x, w, torch.zeros((8, 6)),
                                  torch.zeros((8, 6)), w, 2)
    with pytest.raises(ValueError, match="same grouped-KV width"):
        attn.multi_head_attention(x, x, w, w, torch.zeros((8, 4)), w, 2)
    with pytest.raises(ValueError, match="self-attention"):
        attn.multi_head_attention(x, torch.zeros((1, 5, 8)), w, w, w, w, 2,
                                  rope_positions=torch.arange(4))
