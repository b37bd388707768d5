"""The port's paddle.v2 namespace (``paddle_tpu_torch/v2``) against the
JAX package's (``tests/test_v2_api.py``'s twin) on the CPU: the v2
script shape trained from JAX's weights with JAX's cost at every batch
and JAX's ``infer``; the parameters tar crossing between the packages
both ways, byte for byte; ``checkgrad``; the module shims; and the
package's lazy v2 names.

``init(use_gpu=False)`` pins the CPU through ``FLAGS.use_gpu``, as the
reference's flag did; each test puts the flag back.

Tolerance: float32 on both sides in other summation orders; costs and
outputs within TOL relative.
"""

import io
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu.v2 as jpaddle
from paddle_tpu.layers.graph import reset_names as jax_reset_names
import paddle_tpu_torch.v2 as paddle
from paddle_tpu_torch.layers.graph import reset_names
from paddle_tpu_torch.utils.flags import FLAGS

TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(FLAGS, "use_gpu", FLAGS.use_gpu)
    reset_names()
    jax_reset_names()


def _reader(n=128):
    rng = np.random.RandomState(0)
    xs = rng.randn(n, 4).astype(np.float32)
    ys = (xs.sum(1) > 0).astype(np.int64)

    def r():
        for i in range(n):
            yield xs[i], int(ys[i])
    return r, xs


def _classifier(M):
    x = M.layer.data("x", size=4)
    y = M.layer.fc(x, size=2, act=M.activation.Softmax)
    lab = M.layer.data("lab", size=1)
    return y, M.layer.classification_cost(y, lab)


def _train(M, cost, params, raw, passes=2):
    trainer = M.trainer.SGD(
        cost, parameters=params,
        update_equation=M.optimizer.Adam(learning_rate=0.05))
    seen = []

    def handler(ev):
        if isinstance(ev, M.event.EndIteration):
            seen.append(float(ev.cost))

    trainer.train(M.batch(raw, 32), num_passes=passes, event_handler=handler,
                  feeding={"x": M.data_type.dense_vector(4),
                           "lab": M.data_type.integer_value(2)},
                  log_period=0, buffered_batches=0)
    return seen


def test_v2_script_shape_from_jax_weights_matches_jax():
    paddle.init(use_gpu=False, trainer_count=1)
    assert FLAGS.use_gpu is False
    jpaddle.init(use_gpu=False, trainer_count=1)
    jy, jcost = _classifier(jpaddle)
    jparams = jpaddle.parameters.create(jcost)
    y, cost = _classifier(paddle)
    params = paddle.parameters.create(cost)
    assert params.names() == jparams.names()
    assert all(params.get_shape(n) == jparams.get_shape(n)
               for n in params.names())
    assert next(iter(params.tree.values()))["w0"].device.type == "cpu"
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    params = paddle.parameters.Parameters.from_tar(buf, like=params)
    raw, xs = _reader()
    got = _train(paddle, cost, params, raw)
    want = _train(jpaddle, jcost, jparams, raw)
    assert len(got) == 8
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert np.mean(got[-2:]) < np.mean(got[:2])
    # the caller's Parameters view follows the trained tree
    for name in params.names():
        np.testing.assert_allclose(params[name], jparams[name], rtol=1e-4,
                                   atol=1e-5)
    probs = paddle.infer(output_layer=y, parameters=params,
                         input={"x": xs[:8]})
    jprobs = jpaddle.infer(output_layer=jy, parameters=jparams,
                           input={"x": jnp.asarray(xs[:8])})
    assert tuple(probs.shape) == (8, 2)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-4,
                               atol=1e-6)
    inf = paddle.inference.Inference(y, params)
    np.testing.assert_array_equal(inf.infer({"x": xs[:8]}).numpy(),
                                  probs.numpy())
    # a Python list of floats, as JAX's jnp.asarray takes it (float32)
    listed = paddle.infer(output_layer=y, parameters=params,
                          input={"x": xs[:8].tolist()})
    np.testing.assert_array_equal(listed.numpy(), probs.numpy())


def _pair():
    jx = jpaddle.layer.data("x", size=3)
    jy = jpaddle.layer.fc(jx, size=2, act=None)
    x = paddle.layer.data("x", size=3)
    y = paddle.layer.fc(x, size=2, act=None)
    return jpaddle.parameters.create(jy), paddle.parameters.create(
        y, device="cpu")


def test_parameters_tar_crosses_between_packages_byte_for_byte():
    jparams, params = _pair()
    for name in params.names():
        params[name] = jparams[name]
    a, b = io.BytesIO(), io.BytesIO()
    jparams.to_tar(a)
    params.to_tar(b)
    assert a.getvalue() == b.getvalue()
    # JAX's file read by the port, flat and into a like-tree
    a.seek(0)
    flat = paddle.parameters.Parameters.from_tar(a)
    assert list(flat) == jparams.names()
    for name in jparams.names():
        np.testing.assert_array_equal(flat[name], jparams[name])
    a.seek(0)
    p2 = paddle.parameters.Parameters.from_tar(a, like=params)
    for name in params.names():
        assert isinstance(p2[name], np.ndarray)
        np.testing.assert_array_equal(p2[name], jparams[name])
    # the port's file read by JAX
    rng = np.random.RandomState(3)
    for name in params.names():
        params[name] = rng.randn(*params.get_shape(name)).astype(np.float32)
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    j2 = jpaddle.parameters.Parameters.from_tar(buf, like=jparams)
    for name in params.names():
        np.testing.assert_array_equal(j2[name], params[name])


def test_parameters_tar_roundtrip():
    x = paddle.layer.data("x", size=3)
    y = paddle.layer.fc(x, size=2, act=None)
    params = paddle.parameters.create(y, device="cpu")
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    flat = paddle.parameters.Parameters.from_tar(buf)
    for name in params.names():
        np.testing.assert_array_equal(flat[name], params[name])
    buf.seek(0)
    p2 = paddle.parameters.Parameters.from_tar(buf, like=params)
    for name in params.names():
        np.testing.assert_array_equal(p2[name], params[name])
    # a copy: writing p2 leaves params
    w = next(n for n in params.names() if n.endswith(".w0"))
    p2[w] = np.zeros(params.get_shape(w), np.float32)
    assert np.abs(params[w]).sum() > 0 and not np.abs(p2[w]).any()


def test_create_draws_from_an_explicit_generator():
    x = paddle.layer.data("x", size=3)
    y = paddle.layer.fc(x, size=4, act=None)
    a = paddle.parameters.create(y, seed=5, device="cpu")
    b = paddle.parameters.create(y, seed=5, device="cpu")
    c = paddle.parameters.create(y, seed=6, device="cpu")
    state = torch.random.get_rng_state()
    torch.manual_seed(123)
    d = paddle.parameters.create(y, seed=5, device="cpu")
    torch.random.set_rng_state(state)
    for name in a.names():
        np.testing.assert_array_equal(a[name], b[name])
        np.testing.assert_array_equal(a[name], d[name])
    assert any(not np.array_equal(a[n], c[n]) for n in a.names()
               if a[n].ndim == 2)


def test_checkgrad(np_rng):
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.layers.graph import Topology
    from paddle_tpu_torch.testing import check_topology_grads
    x = L.data_layer("x", size=5)
    lab = L.data_layer("lab", size=1)
    h = L.fc_layer(x, size=6, act="tanh")
    cost = L.classification_cost(L.fc_layer(h, size=3, act="softmax"), lab)
    feed = {"x": torch.tensor(np_rng.randn(4, 5), dtype=torch.float32),
            "lab": torch.tensor(np_rng.randint(0, 3, (4,)))}
    results = check_topology_grads(Topology(cost), feed, device="cpu")
    assert results and all(ok for _, _, ok in results)


def test_v2_module_shims():
    """minibatch / topology / config_base import as the reference's v2
    package, and the namespace lists JAX's names."""
    assert [len(b) for b in paddle.minibatch.batch(
        lambda: iter(range(5)), 2)()] == [2, 2, 1]
    from paddle_tpu_torch.layers.graph import LayerOutput, Topology
    assert paddle.topology.Topology is Topology
    assert paddle.config_base.Layer is LayerOutput
    assert paddle.__all__ == jpaddle.__all__
    assert paddle.batch is paddle.minibatch.batch
    assert paddle.event.TestResult is paddle.event.EndTesting
    assert not hasattr(paddle.dataset, "common")
    from paddle_tpu_torch.data.datasets import wmt14
    assert paddle.dataset.wmt14 is wmt14
    for mod in ("layer", "activation", "pooling", "attr", "networks",
                "optimizer", "reader", "evaluator"):
        jnames = {n for n in dir(getattr(jpaddle, mod))
                  if not n.startswith("_")}
        names = {n for n in dir(getattr(paddle, mod))
                 if not n.startswith("_")}
        assert jnames <= names | {"jax", "jnp"}, (mod, jnames - names)
    assert paddle.optimizer.L2Regularization(0.1) == {"l2": 0.1}
    assert paddle.attr.Param(name="w", initial_std=0.1) == {
        "name": "w", "initial_std": 0.1}


def test_package_binds_jax_v2_names_lazily():
    import subprocess
    code = ("import sys, paddle_tpu_torch as P\n"
            "assert 'torch' not in sys.modules\n"
            "import paddle_tpu_torch.layers as L, paddle_tpu_torch.optim "
            "as O\n"
            "from paddle_tpu_torch.trainer import api\n"
            "assert P.layer is L and P.optimizer is O\n"
            "assert P.init is api.init and P.infer is api.infer\n"
            "try:\n    P.nothing\nexcept AttributeError:\n    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    import paddle_tpu
    import paddle_tpu_torch
    for name in ("init", "infer", "layer", "optimizer"):
        assert hasattr(paddle_tpu, name) and hasattr(paddle_tpu_torch, name)
