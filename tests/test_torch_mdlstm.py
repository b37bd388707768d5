"""The port's 2-D LSTM (``ops/rnn.md_lstm_2d`` and the ``mdlstmemory``
layer) against the JAX package's on the CPU.

``md_lstm_2d`` with and without its five peepholes, ragged in neither
dimension (a 5 x 3 grid at B 3), forward and the gradients of the input,
both recurrent weights and every peephole of ``sum(h * cos(0.37 k))``.
The layer: JAX's init perturbed by seeded noise (so the zero bias and
peepholes carry weight) and carried across with ``params_from_numpy``,
``height`` / ``width`` from the input's image shape and given
explicitly, values and gradients, and the refusal when neither gives
them.  JAX under ``jax.jit``.

Tolerance: float32 on both sides in other summation orders; values
within TOL = 1e-5 and gradients within GRAD_TOL = 1e-4 of each leaf's
largest entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.utils.error import ConfigError

TOL = 1e-5
GRAD_TOL = 1e-4
B, H, W, D = 3, 5, 3, 4
CHECKS = ("check_i_row", "check_i_col", "check_f_row", "check_f_col",
          "check_o")


def _cot(shape, lib):
    n = int(np.prod(shape))
    return lib.cos(0.37 * lib.arange(n, dtype=lib.float32)).reshape(shape)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} of {scale}"


@pytest.mark.parametrize("peepholes", [False, True])
def test_md_lstm_2d_matches_jax(peepholes):
    rng = np.random.RandomState(0)
    args = [rng.randn(B, H, W, 5 * D).astype(np.float32),
            (0.4 * rng.randn(D, 5 * D)).astype(np.float32),
            (0.4 * rng.randn(D, 5 * D)).astype(np.float32)]
    if peepholes:
        args += [(0.3 * rng.randn(D)).astype(np.float32) for _ in CHECKS]

    def jax_loss(a):
        h = jax_rnn.md_lstm_2d(*a[:3], **dict(zip(CHECKS, a[3:])))
        return jnp.sum(h * _cot(h.shape, jnp)), h

    (jl, jh), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        [jnp.asarray(a) for a in args])

    ts = [torch.tensor(a, requires_grad=True) for a in args]
    h = rnn_ops.md_lstm_2d(*ts[:3], **dict(zip(CHECKS, ts[3:])))
    loss = torch.sum(h * _cot(tuple(h.shape), torch))
    loss.backward()
    _close(float(loss.detach()), float(jl), "loss")
    _close(h.detach().numpy(), jh, "h")
    for name, t, g in zip(("x5", "w_r_row", "w_r_col") + CHECKS, ts, jg):
        _close(t.grad.numpy(), g, f"grad {name}", GRAD_TOL)


def from_image(M):
    img = M.data_layer("img", size=5 * D * H * W, height=H, width=W)
    return M.mdlstmemory(img, size=D)


def explicit(M):
    x = M.data_layer("img", size=5 * D * H * W)
    return M.mdlstmemory(x, height=H, width=W, name="md")


@pytest.mark.parametrize("build", [from_image, explicit],
                         ids=lambda b: b.__name__)
def test_mdlstmemory_layer_matches_jax(build):
    jax_reset_names()
    jnode = build(JL)
    jtopo = JL.Topology(jnode)
    rng = np.random.RandomState(1)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), jtopo.init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(2).randn(B, 5 * D * H * W).astype(np.float32)

    def f(p, xx):
        out = jtopo.apply(p, {"img": xx}, mode="test")
        return jnp.sum(out * _cot(out.shape, jnp)), out

    (jl, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))

    L.reset_names()
    node = build(L)
    assert (node.size, node.num_filters, node.img_shape) \
        == (jnode.size, jnode.num_filters, jnode.img_shape) \
        == (D * H * W, D, (H, W))
    topo = L.Topology(node)
    assert topo.param_shapes() == {k: {n: np.shape(a) for n, a in v.items()}
                                   for k, v in tree.items()}
    assert set(tree[node.name]) == {"w_row", "w_col", "b"}
    params = L.params_from_numpy(topo, tree, device="cpu")
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out = topo.apply(params, {"img": tx}, mode="test")
    loss = torch.sum(out * _cot(tuple(out.shape), torch))
    loss.backward()
    _close(float(loss.detach()), float(jl), "loss")
    _close(out.detach().numpy(), jout, "output")
    for k, v in tree.items():
        for n in v:
            _close(params[k][n].grad.numpy(), jgp[k][n], f"grad {k}/{n}",
                   GRAD_TOL)
    _close(tx.grad.numpy(), jgx, "grad input", GRAD_TOL)


def test_port_init_draws_jax_shapes():
    L.reset_names()
    topo = L.Topology(from_image(L))
    p = topo.init(torch.Generator().manual_seed(0), device="cpu")
    (leaf,) = p.values()
    assert leaf["w_row"].shape == leaf["w_col"].shape == (D, 5 * D)
    assert not torch.equal(leaf["w_row"], leaf["w_col"])
    assert leaf["b"].shape == (10 * D,) and not leaf["b"].any()
    L.reset_names()
    nobias = L.mdlstmemory(L.data_layer("img", size=5 * D * H * W,
                                        height=H, width=W), bias_attr=False)
    assert set(L.Topology(nobias).param_shapes()[nobias.name]) \
        == {"w_row", "w_col"}


def test_missing_height_width_refused_as_jax():
    for M, err in ((L, ConfigError), (JL, JaxConfigError)):
        with pytest.raises(err, match="needs height/width"):
            M.mdlstmemory(M.data_layer("flat", size=5 * D * H * W), size=D)
