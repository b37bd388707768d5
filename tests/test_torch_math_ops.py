"""The port's elementwise and small-algebra layer ops
(``paddle_tpu_torch/ops/math_ops.py``) against ``paddle_tpu/ops/
math_ops.py`` on the CPU: every function's output and its gradient with
respect to each float input, on the same seeded numpy inputs.

Tolerances: float32 on both sides, outputs at 1e-6 absolute and relative
(TOL); gradients (of the sum of the output times a seeded cotangent) at
1e-5 absolute and relative (GRAD_TOL: one more product and sum in
either summation order).
"""

import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import math_ops as jax_math
from paddle_tpu_torch.ops import math_ops

TOL = 1e-6
GRAD_TOL = 1e-5
B, D = 4, 6


def _draws(name):
    """Seeded numpy draws for the case ``name``: normal, positive (in
    [0.5, 2)) and uniform [0, 1) arrays of float32."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def positive(*shape):
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)

    def unit(*shape):
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)

    return normal, positive, unit


def _args(*args, **kw):
    return args, kw


# case -> (function, (normal, positive, unit) -> (args, kwargs))
CASES = {
    "addto": ("addto", lambda n, p, u: _args(
        n(B, D), n(B, D), n(B, D), bias=n(D), act="tanh")),
    "interpolation": ("interpolation", lambda n, p, u: _args(
        u(B), n(B, D), n(B, D))),
    "interpolation_col": ("interpolation", lambda n, p, u: _args(
        u(B, 1), n(B, D), n(B, D))),
    "power": ("power", lambda n, p, u: _args(n(B), p(B, D))),
    "scaling": ("scaling", lambda n, p, u: _args(n(B), n(B, D))),
    "slope_intercept": ("slope_intercept", lambda n, p, u: _args(
        n(B, D), slope=1.5, intercept=-0.25)),
    "sum_to_one_norm": ("sum_to_one_norm", lambda n, p, u: _args(p(B, D))),
    "cos_sim": ("cos_sim", lambda n, p, u: _args(n(B, D), n(B, D),
                                                 scale=5.0)),
    "cos_sim_vec_mat": ("cos_sim_vec_mat", lambda n, p, u: _args(
        n(B, D), n(B, 3, D), scale=2.0)),
    "outer_prod": ("outer_prod", lambda n, p, u: _args(n(B, 3), n(B, 5))),
    "trans": ("trans", lambda n, p, u: _args(n(B, D))),
    "rotate": ("rotate", lambda n, p, u: _args(n(B, 2 * 3 * 4), 3, 4)),
    "conv_shift": ("conv_shift", lambda n, p, u: _args(n(B, 7), n(B, 3))),
    "tensor_product": ("tensor_product", lambda n, p, u: _args(
        n(B, 3), n(B, 5), n(2, 3, 5), act="tanh")),
    "feature_map_expand_row": ("feature_map_expand", lambda n, p, u: _args(
        n(B, D), 3)),
    "feature_map_expand_col": ("feature_map_expand", lambda n, p, u: _args(
        n(B, D), 3, as_row_vector=False)),
    "resize": ("resize", lambda n, p, u: _args(n(B, D), 3)),
    "prelu": ("prelu", lambda n, p, u: _args(n(B, D), n(D))),
    "data_norm": ("data_norm", lambda n, p, u: _args(n(B, D), n(D), p(D))),
    "data_norm_min_max": ("data_norm", lambda n, p, u: _args(
        n(B, D), None, None, strategy="min-max", min_=n(D),
        span_inv=p(D))),
}


def _is_float(a):
    return isinstance(a, np.ndarray) and a.dtype == np.float32


def _check(jfn, tfn, args, kw, seed=0):
    """Output and the gradients of sum(out * cotangent) with respect to
    every float array argument (positional or keyword), both packages."""
    keys = [("a", i) for i, a in enumerate(args) if _is_float(a)] \
        + [("k", k) for k, v in sorted(kw.items()) if _is_float(v)]

    def call(fn, vals, conv):
        a = [conv(x) if isinstance(x, np.ndarray) else x for x in args]
        k = {n: conv(v) if isinstance(v, np.ndarray) else v
             for n, v in kw.items()}
        for (where, key), v in zip(keys, vals):
            if where == "a":
                a[key] = v
            else:
                k[key] = v
        return fn(*a, **k)

    prim = [args[k] if w == "a" else kw[k] for w, k in keys]
    want = np.asarray(call(jfn, [jnp.asarray(p) for p in prim],
                           jnp.asarray))
    cot = np.random.RandomState(seed).standard_normal(want.shape).astype(
        np.float32)
    jgrads = jax.grad(lambda *v: jnp.sum(call(jfn, v, jnp.asarray) * cot),
                      argnums=tuple(range(len(prim))))(
        *[jnp.asarray(p) for p in prim])
    tv = [torch.tensor(p, requires_grad=True) for p in prim]
    got = call(tfn, tv, torch.tensor)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    torch.sum(got * torch.tensor(cot)).backward()
    for t, g in zip(tv, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_op_matches_jax(name):
    fname, make = CASES[name]
    _check(getattr(jax_math, fname), getattr(math_ops, fname),
           *make(*_draws(name)))


def test_multiplex_matches_jax():
    """Per-row picks among three inputs from an index of [B] or [B, 1];
    out-of-range picks clip to the ends, as JAX's."""
    normal, _, _ = _draws("multiplex")
    xs = tuple(normal(B, D) for _ in range(3))
    for index in (np.array([0, 2, 1, 5], np.int32),
                  np.array([[-1], [1], [2], [0]], np.int32)):
        _check(lambda *x: jax_math.multiplex(jnp.asarray(index), *x),
               lambda *x: math_ops.multiplex(torch.tensor(index), *x), xs,
               {})


def test_pad_value_replace_matches_jax():
    normal, _, unit = _draws("pad_value_replace")
    mask = (unit(B, D) > 0.5).astype(np.float32)
    _check(lambda x: jax_math.pad_value_replace(x, jnp.asarray(mask),
                                                value=-3.0),
           lambda x: math_ops.pad_value_replace(x, torch.tensor(mask),
                                                value=-3.0),
           (normal(B, D),), {})
