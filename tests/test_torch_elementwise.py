"""The port's elementwise layers (``layers/api.py``: interpolation,
power, scaling, slope_intercept, linear_comb / convex_comb,
sum_to_one_norm, cos_sim in both forms, out_prod, trans, rotate, tensor,
multiplex, conv_shift, featmap_expand, resize, repeat, prelu,
selective_fc) and the arithmetic on ``LayerOutput``
(``layers/layer_math.py``) against the JAX package's on the CPU.

Each case builds a small graph in both DSLs (``build(M)``, M the JAX or
the port's ``layers``), carries JAX's init across
(``params_from_numpy``) and holds, on inputs from a numpy seed
(``check_layer``): the output, the gradient of the output summed against
a seeded cotangent with respect to every float input and every
parameter.  Sequence inputs are ragged, length 1 included.

Tolerances: float32 on both sides in other summation orders: outputs
within 1e-5 of their largest entry (TOL), each gradient leaf within 1e-5
of its largest entry (GRAD_TOL).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

TOL = 1e-5
GRAD_TOL = 1e-5
B, T, D = 6, 7, 5
LENGTHS = np.array([7, 1, 4, 6, 2, 5], np.int32)


def close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max() if want.size else 0.0,
                            1e-30), (what, err, np.abs(want).max())


def _value(v):
    """(data, lengths or None) of a layer's value."""
    if isinstance(v, (JaxSeq, SequenceBatch)):
        return v.data, v.lengths
    return v, None


def check_layer(build, feed, seed=0, tol=TOL, grad_tol=GRAD_TOL,
                cot_seed=7):
    """``build(M)`` in both DSLs on JAX's init, fed ``feed`` ({name:
    array, or (data, lengths) for a sequence}): the output (and its
    lengths), then, for a float output, the gradients of sum(output *
    cotangent) with respect to every float feed and every parameter.
    Returns (port output, JAX output) as numpy."""
    jax_reset_names()
    jtopo = JL.Topology(build(JL))
    L.reset_names()
    ttopo = L.Topology(build(L))
    assert [n.name for n in ttopo.order] == [n.name for n in jtopo.order]
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtopo.init(jax.random.PRNGKey(seed)))
    params = L.params_from_numpy(ttopo, tree, "cpu")
    names = list(ttopo.data_layers)
    arrays = {k: feed[k][0] if isinstance(feed[k], tuple) else feed[k]
              for k in names}
    diff = [k for k in names if arrays[k].dtype.kind == "f"]

    def jfeed(xs):
        out = {}
        for k in names:
            a = xs[k] if k in xs else jnp.asarray(arrays[k])
            out[k] = JaxSeq(a, jnp.asarray(feed[k][1])) \
                if isinstance(feed[k], tuple) else a
        return out

    def jout(p, xs):
        return _value(jtopo.apply(p, jfeed(xs), mode="train"))

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jxs = {k: jnp.asarray(arrays[k]) for k in diff}
    want, want_len = jax.jit(jout)(jp, jxs)
    txs = {k: torch.tensor(arrays[k]) for k in names}
    tfeed = {k: SequenceBatch(txs[k], torch.tensor(feed[k][1]))
             if isinstance(feed[k], tuple) else txs[k] for k in names}
    float_out = np.asarray(want).dtype.kind == "f"
    if float_out:
        for t in tree_leaves(params) + [txs[k] for k in diff]:
            t.requires_grad_(True)
    got, got_len = _value(ttopo.apply(params, tfeed, mode="train"))
    close(got.detach().numpy(), want, tol, "value")
    assert got.dtype == torch.float32 if float_out else not \
        got.dtype.is_floating_point
    if want_len is not None:
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if got.requires_grad:
        cot = np.random.RandomState(cot_seed).randn(
            *np.shape(want)).astype(np.float32)
        jg, jgx = jax.jit(jax.grad(
            lambda p, xs: jnp.sum(jout(p, xs)[0] * cot), argnums=(0, 1)))(
            jp, jxs)
        (got * torch.tensor(cot)).sum().backward()
        for k in tree:
            for n in tree[k]:
                close(params[k][n].grad.numpy(), jg[k][n], grad_tol,
                      f"d {k}/{n}")
        for k in diff:
            # a feed read only for its lengths or shape has no gradient
            g = txs[k].grad if txs[k].grad is not None \
                else torch.zeros_like(txs[k])
            close(g.numpy(), jgx[k], grad_tol, f"d feed {k}")
    return got.detach().numpy(), np.asarray(want)


def feed_arrays():
    """The numpy feed of every data layer in this file and its siblings:
    arrays, or (data, lengths) for sequences."""
    r = np.random.RandomState(3)
    f = np.float32
    return {
        "x": r.randn(B, D).astype(f), "y": r.randn(B, D).astype(f),
        "z": r.randn(B, D).astype(f),
        "pos": r.uniform(0.5, 2.0, (B, D)).astype(f),
        "w01": r.uniform(0, 1, (B, 1)).astype(f),
        "p": r.uniform(0.5, 2.0, (B, 1)).astype(f),
        "s1": r.randn(B, 1).astype(f),
        "k3": r.randn(B, 3).astype(f),
        "v12": r.randn(B, 12).astype(f),
        "a3": r.randn(B, 3).astype(f), "b4": r.randn(B, 4).astype(f),
        "m15": r.randn(B, 3 * D).astype(f),
        "img": r.randn(B, 2 * 3 * 4).astype(f),
        "a6": r.randn(B, 6).astype(f),
        "idx": r.randint(0, 3, (B,)).astype(np.int32),
        "sel": (r.uniform(0, 1, (B, 4)) < 0.5).astype(f),
        "xs": (r.randn(B, T, D).astype(f), LENGTHS),
        "ys": (r.randn(B, T, D).astype(f), LENGTHS),
        "ws": (r.uniform(0, 1, (B, T, 1)).astype(f), LENGTHS),
    }


def _d(M, name, size=D, seq=False):
    return M.data_layer(name, size=size, is_seq=seq)


def _fc(M, src="x", size=D, act="tanh"):
    return M.fc_layer(_d(M, src), size=size, act=act)


# name -> the graph in DSL module M
LAYERS = {
    "interpolation": lambda M: M.interpolation_layer(
        [_fc(M), _d(M, "y")], weight=_d(M, "w01", 1)),
    "interpolation_seq": lambda M: M.interpolation_layer(
        [_d(M, "xs", seq=True), _d(M, "ys", seq=True)],
        weight=_d(M, "ws", 1, seq=True)),
    "power": lambda M: M.power_layer(_d(M, "pos"), weight=_d(M, "p", 1)),
    "scaling": lambda M: M.scaling_layer(_fc(M), weight=_d(M, "s1", 1)),
    "slope_intercept": lambda M: M.slope_intercept_layer(
        _fc(M), slope=2.0, intercept=-0.5),
    "linear_comb": lambda M: M.linear_comb_layer(
        _d(M, "k3", 3), _d(M, "v12", 12), size=4),
    "convex_comb_default_size": lambda M: M.convex_comb_layer(
        _d(M, "k3", 3), _d(M, "v12", 12)),
    "sum_to_one_norm": lambda M: M.sum_to_one_norm_layer(_d(M, "pos")),
    "cos_sim": lambda M: M.cos_sim(_fc(M), _d(M, "y"), scale=5.0),
    "cos_sim_vec_mat": lambda M: M.cos_sim(_d(M, "x"), _d(M, "m15", 3 * D),
                                           scale=2.0, size=3),
    "out_prod": lambda M: M.out_prod_layer(_d(M, "a3", 3), _d(M, "b4", 4)),
    "trans": lambda M: M.trans_layer(_fc(M)),
    "rotate": lambda M: M.rotate_layer(_d(M, "img", 24), height=3, width=4),
    "tensor": lambda M: M.tensor_layer(_d(M, "a3", 3), _d(M, "b4", 4),
                                       size=5, act="tanh"),
    "multiplex": lambda M: M.multiplex_layer(
        [_d(M, "idx", 1), _fc(M), _d(M, "y"), _d(M, "z")]),
    "conv_shift": lambda M: M.conv_shift_layer(_d(M, "a6", 6),
                                               _d(M, "a3", 3)),
    "featmap_expand_rows": lambda M: M.featmap_expand_layer(
        _fc(M), num_filters=3),
    "featmap_expand_elements": lambda M: M.featmap_expand_layer(
        _fc(M), num_filters=3, as_row_vector=False),
    "resize": lambda M: M.resize_layer(_d(M, "a6", 6), size=4),
    "repeat": lambda M: M.repeat_layer(_fc(M), 3),
    "repeat_seq": lambda M: M.repeat_layer(_d(M, "xs", seq=True), 2),
    "prelu": lambda M: M.prelu_layer(_fc(M, act=None)),
    "prelu_partial_sum": lambda M: M.prelu_layer(_d(M, "a6", 6),
                                                 partial_sum=2),
    "selective_fc": lambda M: M.selective_fc_layer(_d(M, "x"), size=4),
    "selective_fc_select": lambda M: M.selective_fc_layer(
        _d(M, "x"), size=4, select=_d(M, "sel", 4), act="sigmoid"),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_elementwise_layer_matches_jax(case):
    check_layer(LAYERS[case], feed_arrays())


def test_node_sizes_match_jax():
    """Every case's output node declares JAX's size, trans and resize
    included (they reshape the whole batch matrix)."""
    for case, build in LAYERS.items():
        jax_reset_names()
        L.reset_names()
        assert build(L).size == build(JL).size, case
    L.reset_names()
    assert L.trans_layer(_d(L, "x")).size == D
    assert not L.resize_layer(_d(L, "xs", seq=True), size=4).is_seq


def test_linear_comb_without_size_raises_like_jax():
    for M, err in ((L, ConfigError), (JL, JaxConfigError)):
        with pytest.raises(err, match="needs size"):
            M.linear_comb_layer(_d(M, "k3", 3), _d(M, "x"))


# ------------------------------------------------------------ layer_math

UNARY = ("exp", "log", "abs", "sigmoid", "tanh", "square", "relu", "sqrt")


@pytest.mark.parametrize("op", UNARY)
def test_layer_math_unary_matches_jax(op):
    src = "pos" if op in ("log", "sqrt") else "x"
    check_layer(lambda M: getattr(M.layer_math, op)(_fc(M, src, act=None)
                                                   if src == "x"
                                                   else _d(M, src)),
                feed_arrays())


def _a(M):
    return _fc(M)


# name -> the expression in DSL module M
OPERATORS = {
    "add_number": lambda M: _a(M) + 2.0,
    "radd_number": lambda M: 2.0 + _a(M),
    "sub_number": lambda M: _a(M) - 1.5,
    "rsub_number": lambda M: 1.5 - _a(M),
    "mul_number": lambda M: _a(M) * 3.0,
    "rmul_number": lambda M: 3.0 * _a(M),
    "add_layer": lambda M: _a(M) + _d(M, "y"),
    "sub_layer": lambda M: _a(M) - _d(M, "y"),
    "add_size1_right": lambda M: _a(M) + _d(M, "s1", 1),
    "add_size1_left": lambda M: _d(M, "s1", 1) + _a(M),
    "sub_size1_right": lambda M: _a(M) - _d(M, "s1", 1),
    "sub_size1_left": lambda M: _d(M, "s1", 1) - _a(M),
    "mul_size1_right": lambda M: _a(M) * _d(M, "s1", 1),
    "mul_size1_left": lambda M: _d(M, "s1", 1) * _a(M),
}


@pytest.mark.parametrize("case", sorted(OPERATORS))
def test_layer_math_operator_matches_jax(case):
    check_layer(OPERATORS[case], feed_arrays())


def test_layer_math_refusals_match_jax():
    for M, err in ((L, ConfigError), (JL, JaxConfigError)):
        a, b = _d(M, "x"), _d(M, "a6", 6)
        with pytest.raises(err, match="cannot add sizes"):
            a + b
        with pytest.raises(err, match="size-1"):
            a * b
        with pytest.raises(err, match="LayerOutput"):
            a + "one"
