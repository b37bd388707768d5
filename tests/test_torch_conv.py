"""``paddle_tpu_torch/ops/conv.py``, ``ops/norm.py`` (batch and RMS
norm) and the image initializers against the JAX package on the CPU:
every function of ``ops/conv`` at small NHWC shapes from numpy draws --
groups, dilation, stride, the transposed conv, symmetric and
asymmetric (ceil-mode) pools, LRN, bilinear up and down, SPP,
``block_expand`` and ``prior_box`` -- the gradients of ``conv2d`` and
the pools against ``jax.grad``, and ``conv2d`` under the bf16 policy.

Tolerances: float32 on both sides in other summation orders, 1e-5
absolute and relative (TOL); gradients 2e-5 (two products deep).  Under
the bf16 policy both sides convolve the same bf16-rounded operands with
a float32 accumulator, so the float32 outputs agree to 1e-5 too, and
each gradient -- rounded once to bf16 on both sides -- lies within one
bf16 step (2^-7 of its power of two) plus 1e-5 of JAX's.
``prior_box`` and the pads are exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core import dtypes as jax_dtypes
from paddle_tpu.ops import conv as jconv
from paddle_tpu.ops import initializers as jinit
from paddle_tpu.ops import norm as jnorm
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.ops import conv
from paddle_tpu_torch.ops import initializers
from paddle_tpu_torch.ops import norm

TOL = 1e-5
GRAD_TOL = 2e-5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


CONV_CASES = [
    # (B, H, W, Cin, kh, kw, Cout, stride, padding, groups, dilation)
    (2, 9, 8, 4, 3, 3, 6, (1, 1), (1, 1), 1, (1, 1)),
    (2, 11, 10, 4, 5, 3, 8, (2, 3), (2, 0), 2, (1, 1)),
    (1, 12, 12, 6, 3, 3, 6, (1, 2), (0, 1), 3, (2, 1)),
    (1, 7, 7, 3, 1, 1, 5, (2, 2), (0, 0), 1, (1, 1)),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_and_its_gradients(case):
    b, h, w, cin, kh, kw, cout, stride, pad, groups, dil = case
    rng = np.random.RandomState(1)
    x, wt, bias = (_arr(rng, b, h, w, cin), _arr(rng, kh, kw, cin // groups,
                                                  cout), _arr(rng, cout))

    def jf(x_, w_, b_):
        return jconv.conv2d(x_, w_, b_, stride, pad, groups, dil,
                            act="relu")
    want = jf(x, wt, bias)
    cot = _arr(rng, *want.shape)
    jgrads = jax.grad(lambda *a: jnp.sum(jf(*a) * cot), argnums=(0, 1, 2))(
        x, wt, bias)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, wt, bias)]
    got = conv.conv2d(*leaves, stride=stride, padding=pad, groups=groups,
                      dilation=dil, act="relu")
    _close(got, want)
    (got * torch.tensor(cot)).sum().backward()
    for leaf, g in zip(leaves, jgrads):
        _close(leaf.grad, g, GRAD_TOL)


@pytest.mark.parametrize("stride,pad", [((1, 1), (0, 0)), ((2, 2), (1, 1)),
                                        ((2, 3), (1, 0))])
def test_conv2d_transpose(stride, pad):
    rng = np.random.RandomState(2)
    x, wt, bias = _arr(rng, 2, 5, 6, 3), _arr(rng, 3, 4, 7, 3), _arr(rng, 7)
    want = jconv.conv2d_transpose(x, wt, bias, stride, pad)
    cot = _arr(rng, *want.shape)
    jgrads = jax.grad(lambda x_, w_: jnp.sum(jconv.conv2d_transpose(
        x_, w_, None, stride, pad) * cot), argnums=(0, 1))(x, wt)
    got = conv.conv2d_transpose(torch.tensor(x), torch.tensor(wt),
                                torch.tensor(bias), stride, pad)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, wt)]
    (conv.conv2d_transpose(*leaves, None, stride, pad)
     * torch.tensor(cot)).sum().backward()
    for leaf, g in zip(leaves, jgrads):
        _close(leaf.grad, g, GRAD_TOL)


def test_conv_output_size():
    for args in ((32, 5, 1, 2), (227, 11, 4, 1), (28, 5, 1, 0), (7, 3, 2, 1)):
        assert conv.conv_output_size(*args) == jconv.conv_output_size(*args)


POOL_CASES = [
    # window, stride, padding (symmetric or (lo, hi) pairs)
    ((2, 2), (2, 2), (0, 0)),
    ((3, 3), (2, 2), (1, 1)),
    ((3, 3), (1, 1), (1, 1)),
    ((3, 2), (2, 2), ((0, 1), (1, 2))),      # ceil-mode overhang
    ((3, 3), (2, 2), ((1, 2), (1, 2))),
]


@pytest.mark.parametrize("window,stride,pad", POOL_CASES)
@pytest.mark.parametrize("kind", ["max", "avg", "avg_incl"])
def test_pools_and_their_gradients(kind, window, stride, pad):
    rng = np.random.RandomState(3)
    x = _arr(rng, 2, 7, 8, 3)
    if kind == "max":
        jf = lambda a: jconv.max_pool2d(a, window, stride, pad)  # noqa: E731
        tf = lambda a: conv.max_pool2d(a, window, stride, pad)   # noqa: E731
    else:
        excl = kind == "avg"
        jf = lambda a: jconv.avg_pool2d(a, window, stride, pad,  # noqa: E731
                                        exclude_pad=excl)
        tf = lambda a: conv.avg_pool2d(a, window, stride, pad,   # noqa: E731
                                       exclude_pad=excl)
    want = jf(x)
    cot = _arr(rng, *want.shape)
    jg = jax.grad(lambda a: jnp.sum(jf(a) * cot))(x)
    leaf = torch.tensor(x, requires_grad=True)
    got = tf(leaf)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    (got * torch.tensor(cot)).sum().backward()
    _close(leaf.grad, jg, GRAD_TOL)


def test_channel_ops():
    """LRN (the reference's default scale and the AlexNet one, an even
    window), cross-channel norm, maxout, pad_chw."""
    rng = np.random.RandomState(4)
    x = _arr(rng, 2, 4, 5, 8)
    t = torch.tensor(x)
    for size, scale, power in ((5, 0.0128, 0.75), (5, 1e-4, 0.75),
                               (4, 0.01, 0.5)):
        _close(conv.lrn_cross_map(t, size, scale, power),
               jconv.lrn_cross_map(x, size, scale, power))
    s = np.abs(_arr(rng, 8)) + 0.5
    _close(conv.cross_channel_norm(t, torch.tensor(s)),
           jconv.cross_channel_norm(x, s))
    for groups in (2, 4):
        _close(conv.maxout(t, groups), jconv.maxout(x, groups), 0)
    got = conv.pad_chw(t, (1, 2), (0, 1), (2, 0))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jconv.pad_chw(x, (1, 2), (0, 1), (2, 0))))


@pytest.mark.parametrize("out_hw", [(10, 13), (3, 2), (4, 9), (7, 5)])
def test_bilinear_interp_up_and_down(out_hw):
    """Upsampling, downsampling (JAX antialiases: not F.interpolate's
    numbers), one axis each way, one axis kept."""
    rng = np.random.RandomState(5)
    x = _arr(rng, 2, 7, 5, 3)
    _close(conv.bilinear_interp(torch.tensor(x), *out_hw),
           jconv.bilinear_interp(x, *out_hw))


@pytest.mark.parametrize("block,stride,pad", [((2, 2), (2, 2), (0, 0)),
                                              ((3, 2), (1, 2), (1, 1))])
def test_block_expand(block, stride, pad):
    rng = np.random.RandomState(6)
    x = _arr(rng, 2, 6, 7, 3)
    np.testing.assert_array_equal(
        conv.block_expand(torch.tensor(x), block, stride, pad).numpy(),
        np.asarray(jconv.block_expand(x, block, stride, pad)))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_adaptive_pool_and_spp(pool_type):
    """Uneven windows (7 and 5 into 3 bins), and the pyramid of 1, 2, 4
    bins on a map smaller than its finest level in one axis."""
    rng = np.random.RandomState(7)
    x = _arr(rng, 2, 7, 5, 3)
    t = torch.tensor(x)
    _close(conv.adaptive_pool2d(t, 3, pool_type),
           jconv.adaptive_pool2d(x, 3, pool_type))
    _close(conv.spatial_pyramid_pool(t, 3, pool_type),
           jconv.spatial_pyramid_pool(x, 3, pool_type))
    y = _arr(rng, 1, 3, 6, 2)
    _close(conv.spatial_pyramid_pool(torch.tensor(y), 3, pool_type),
           jconv.spatial_pyramid_pool(y, 3, pool_type))


def test_prior_box():
    for args in (((3, 4), (30, 40), [8.0], [16.0], [2.0]),
                 ((2, 2), (20, 20), [4.0, 9.0], [], [1.0, 3.0])):
        np.testing.assert_array_equal(conv.prior_box(*args).numpy(),
                                      np.asarray(jconv.prior_box(*args)))


@pytest.fixture
def bf16_policy():
    """Both packages' compute policy bf16 for the test."""
    dtypes.set_policy(compute_dtype="bfloat16")
    jax_dtypes.set_policy(compute_dtype="bfloat16")
    try:
        yield
    finally:
        dtypes.set_policy()
        jax_dtypes.set_policy()


def _within_a_bf16_step(got, want):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    with np.errstate(divide="ignore"):
        step = np.exp2(np.floor(np.log2(np.abs(w))) - 7)
    bad = np.abs(g - w) > step + TOL
    assert not bad.any(), (float(np.abs(g - w).max()), int(bad.sum()))


@pytest.mark.parametrize("trans", [False, True])
def test_conv_under_the_bf16_policy(bf16_policy, trans):
    """float32 operands rounded to bf16: a float32 output (JAX's
    accumulator, not a bf16 ``F.conv2d``'s), within TOL of JAX's; the
    gradients rounded to bf16 once, within one bf16 step of JAX's."""
    rng = np.random.RandomState(8)
    x = _arr(rng, 2, 6, 6, 4)
    wt = _arr(rng, 3, 3, 4, 4)
    if trans:
        jf = lambda a, w_: jconv.conv2d_transpose(  # noqa: E731
            a, w_, None, (2, 2), (1, 1))
        tf = lambda a, w_: conv.conv2d_transpose(   # noqa: E731
            a, w_, None, (2, 2), (1, 1))
    else:
        jf = lambda a, w_: jconv.conv2d(a, w_, None, (1, 1), (1, 1))  # noqa
        tf = lambda a, w_: conv.conv2d(a, w_, None, (1, 1), (1, 1))   # noqa
    want = jf(x, wt)
    assert want.dtype == jnp.float32
    cot = _arr(rng, *want.shape)
    jgrads = jax.grad(lambda a, w_: jnp.sum(jf(a, w_) * cot),
                      argnums=(0, 1))(x, wt)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, wt)]
    got = tf(*leaves)
    assert got.dtype == torch.float32
    _close(got, want)
    (got * torch.tensor(cot)).sum().backward()
    for leaf, g in zip(leaves, jgrads):
        assert leaf.grad.dtype == torch.float32
        _within_a_bf16_step(leaf.grad, g)


def test_batch_norm_train_infer_and_rms_norm():
    """Biased variance in the normalization and in the moving variance,
    ``momentum`` the weight of the old stats; over [B, H, W, C] and
    [N, C]; the inference form on the moving stats; rms_norm."""
    rng = np.random.RandomState(9)
    for shape in ((3, 4, 5, 6), (7, 6)):
        x = _arr(rng, *shape) * 2.0 + 0.5
        g, bt = _arr(rng, 6), _arr(rng, 6)
        mm, mv = _arr(rng, 6), np.abs(_arr(rng, 6)) + 0.5
        jy, (jm, jv) = jnorm.batch_norm_train(x, g, bt, mm, mv, 0.8)
        ty, (tm, tv) = norm.batch_norm_train(
            *(torch.tensor(a) for a in (x, g, bt, mm, mv)), 0.8)
        for got, want in ((ty, jy), (tm, jm), (tv, jv)):
            _close(got, want)
        assert not tm.requires_grad and not tv.requires_grad
        _close(norm.batch_norm_infer(*(torch.tensor(a) for a in (
            x, g, bt, mm, mv))), jnorm.batch_norm_infer(x, g, bt, mm, mv))
        _close(norm.rms_norm(torch.tensor(x), torch.tensor(g)),
               jnorm.rms_norm(x, g))


def test_image_initializers():
    """xavier, msra and conv_default: shape, dtype, device and spread
    by the JAX package's rules (the random bits are each package's own:
    the spreads are compared on 40000 draws, within 3%)."""
    gen = torch.Generator().manual_seed(0)
    shape = (5, 5, 16, 100)
    for name, bound_or_std, uniform in (
            ("xavier", np.sqrt(6.0 / (5 + 100)), True),
            ("msra", np.sqrt(2.0 / 5), False),
            ("conv_default", 1.0 / np.sqrt(5 * 5 * 16), False)):
        t = getattr(initializers, name)()(gen, shape)
        j = np.asarray(getattr(jinit, name)()(jax.random.PRNGKey(0), shape))
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        spread = float(t.abs().max()) if uniform else float(t.std())
        jspread = float(np.abs(j).max()) if uniform else float(j.std())
        assert abs(spread - bound_or_std) < 0.03 * bound_or_std
        assert abs(jspread - bound_or_std) < 0.03 * bound_or_std
