"""The port's int8 weight-streaming trainer (``trainer.SGD(quant_weights=
True)``) against the JAX package's on the CPU, and the int8 KV
quantizer's scale division (``quant/kv.quantize_heads``).

Config: an fc(tanh) -> fc(softmax) classifier on dense inputs (dim 32,
hidden 64, B 16), every weight quantized (``quant_min_size`` 64), from
the JAX ``Topology.init`` weights, Momentum lr 0.05 m 0.9, on the same
batches.  Tolerances: the losses over 5 steps within 1e-4 relative (the
int8 view is the same on both sides, the products sum in other orders,
and the masters drift by ulps per step); the int8 twin of the initial
masters and after step 1 equal code for code, scales within 1e-6
relative (the masters after a step differ by ulps, which an amax can
carry); a checkpoint carries every array bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.data import dense_vector as jax_dense_vector
from paddle_tpu.data import integer_value as jax_integer_value
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.quant import kv as jax_kvq
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import dense_vector, integer_value
from paddle_tpu_torch.quant import kv as kvq
from paddle_tpu_torch.quant import weights as qw
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

DIM, HIDDEN, B, STEPS, MIN_SIZE = 32, 64, 16, 5, 64
LOSS_RTOL, SCALE_RTOL = 1e-4, 1e-6
FEEDING = {"x": dense_vector(DIM), "lab": integer_value(2)}
JAX_FEEDING = {"x": jax_dense_vector(DIM), "lab": jax_integer_value(2)}
# the weights quantize_tree picks at MIN_SIZE: both fc weights
QUANT_KEYS = {"['__fc_0__']['w0']", "['__fc_1__']['w0']"}


def _net(M):
    (jax_reset_names if M is JL else L.reset_names)()
    x = M.data_layer("x", size=DIM)
    lab = M.data_layer("lab", size=1)
    h = M.fc_layer(x, size=HIDDEN, act="tanh")
    y = M.fc_layer(h, size=2, act="softmax")
    return M.classification_cost(y, lab)


def _batches(seed, n=STEPS):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, B, DIM).astype(np.float32)
    ys = (xs.sum(-1) > 0).astype(np.int64)
    return [[(xs[i, j], int(ys[i, j])) for j in range(B)] for i in range(n)]


def _jax_trainer(quant=True, parameters=None):
    return JaxSGD(_net(JL), parameters=parameters,
                  update_equation=jax_optim.Momentum(learning_rate=0.05,
                                                     momentum=0.9),
                  quant_weights=quant, quant_min_size=MIN_SIZE, seed=3)


def _port_trainer(quant=True, parameters=None):
    return SGD(_net(L), parameters=parameters,
               update_equation=optim.Momentum(learning_rate=0.05,
                                              momentum=0.9),
               quant_weights=quant, quant_min_size=MIN_SIZE, device="cpu")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_qtree(got, want, scale_rtol=0.0):
    """The port's int8 twin against a JAX one: the same keys, codes
    equal, scales within ``scale_rtol``."""
    assert set(got) == set(want) == QUANT_KEYS
    for key in want:
        assert got[key]["q"].dtype == torch.int8
        assert got[key]["s"].dtype == torch.float32
        np.testing.assert_array_equal(got[key]["q"].numpy(),
                                      np.asarray(want[key]["q"]))
        np.testing.assert_allclose(got[key]["s"].numpy(),
                                   np.asarray(want[key]["s"]),
                                   rtol=scale_rtol, atol=0)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX int8 trainer's initial masters and twin, its twin after
    step 1 and its losses over STEPS steps."""
    jt = _jax_trainer()
    start, q0 = _host(jt.parameters), _host(jt._qtree)
    losses, q1 = [], None
    for batch in _batches(1):
        losses.append(float(jt.train_one_batch(batch, feeder=JAX_FEEDING)))
        if q1 is None:
            q1 = _host(jt._qtree)
    return start, q0, q1, losses


def test_int8_trainer_matches_jax(jax_run):
    """Five steps from the same masters on the same batches: the int8
    twin before and after step 1, and the losses."""
    start, q0, q1, want = jax_run
    trainer = _port_trainer(parameters=start)
    _same_qtree(trainer._qtree, q0)
    losses = []
    for i, batch in enumerate(_batches(1)):
        losses.append(float(trainer.train_one_batch(batch, feeder=FEEDING)))
        if i == 0:
            _same_qtree(trainer._qtree, q1, SCALE_RTOL)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert trainer.opt_state["step"] == STEPS
    # between steps: the masters float32, the twin int8 codes + float32
    # scales, the twin the masters' own requantization
    for key, leaf in trainer._qtree.items():
        layer, name = key[2:-2].split("']['")
        master = trainer.parameters[layer][name]
        assert master.dtype == torch.float32 and not master.requires_grad
        again = qw.quantize_leaf(master.detach())
        assert torch.equal(again["q"], leaf["q"])
        assert torch.equal(again["s"], leaf["s"])
    assert trainer._view is None


def test_int8_trainer_tracks_its_float32_twin():
    """The int8 step against the float32 step from the same weights: the
    loss gap within quant/weights.TRAIN_LOSS_BUDGET, and the int8 loss
    not equal to the float32 one (the forward reads the int8 view)."""
    start = _host(_jax_trainer().parameters)
    qt, ft = _port_trainer(parameters=start), _port_trainer(
        quant=False, parameters=start)
    gaps = []
    for batch in _batches(2, 8):
        q = float(qt.train_one_batch(batch, feeder=FEEDING))
        f = float(ft.train_one_batch(batch, feeder=FEEDING))
        gaps.append(abs(q - f) / max(abs(f), 1.0))
    assert 0 < max(gaps) <= qw.TRAIN_LOSS_BUDGET


def test_int8_checkpoints_both_directions_and_across_packages(tmp_path):
    """An int8 trainer's pass dir holds the {"master", "q"} bundle: into
    a plain trainer it gives the masters, into an int8 trainer the
    masters and the twin; a plain pass dir into an int8 trainer
    requantizes its params.  The JAX and the port's int8 trainers read
    each other's bundle bit for bit."""
    start = _host(_jax_trainer().parameters)
    batch = _batches(3, 1)[0]
    qt = _port_trainer(parameters=start)
    qt.train_one_batch(batch, feeder=FEEDING)
    qt.save(str(tmp_path / "port_q"), pass_id=0)
    plain = _port_trainer(quant=False)
    plain.load(str(tmp_path / "port_q"))
    for a, b in zip(tree_leaves(plain.parameters),
                    tree_leaves(qt.parameters)):
        assert torch.equal(a.detach(), b.detach())
    assert plain._qtree is None
    other = _port_trainer()
    other.load(str(tmp_path / "port_q"))
    for key in QUANT_KEYS:
        for k in ("q", "s"):
            assert torch.equal(other._qtree[key][k], qt._qtree[key][k])
    plain.save(str(tmp_path / "port_plain"), pass_id=0)
    requant = _port_trainer()
    requant.load(str(tmp_path / "port_plain"))
    for key in QUANT_KEYS:
        for k in ("q", "s"):
            assert torch.equal(requant._qtree[key][k], qt._qtree[key][k])
    # JAX -> port
    jt = _jax_trainer(parameters=start)
    jt.train_one_batch(batch, feeder=JAX_FEEDING)
    jt.save(str(tmp_path / "jax_q"), pass_id=0, block=True)
    from_jax = _port_trainer()
    from_jax.load(str(tmp_path / "jax_q"))
    _same_qtree(from_jax._qtree, _host(jt._qtree))
    for a, b in zip(tree_leaves(from_jax.parameters),
                    jax.tree_util.tree_leaves(_host(jt.parameters))):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    # port -> JAX
    back = _jax_trainer()
    back.load(str(tmp_path / "port_q"))
    _same_qtree(qt._qtree, _host(back._qtree))
    for a, b in zip(tree_leaves(qt.parameters),
                    jax.tree_util.tree_leaves(_host(back.parameters))):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    # and the bundle keeps training: the same next loss in both
    nxt = _batches(4, 1)[0]
    np.testing.assert_allclose(
        float(from_jax.train_one_batch(nxt, feeder=FEEDING)),
        float(jt.train_one_batch(nxt, feeder=JAX_FEEDING)), rtol=LOSS_RTOL)


def test_cli_quant_train_writes_the_bundle(tmp_path):
    """``python -m paddle_tpu_torch train --quant-train`` trains the int8
    mode (the JAX CLI's flag) and its pass dir holds both trees."""
    from paddle_tpu_torch.trainer import cli
    from paddle_tpu_torch.trainer.checkpoint import load_checkpoint
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "import numpy as np\n"
        "import paddle_tpu_torch.layers as L\n"
        "from paddle_tpu_torch import optim\n"
        "from paddle_tpu_torch.data import dense_vector, integer_value\n"
        "def get_config():\n"
        "    x = L.data_layer('x', size=32)\n"
        "    lab = L.data_layer('lab', size=1)\n"
        "    h = L.fc_layer(x, size=64, act='tanh')\n"
        "    y = L.fc_layer(h, size=2, act='softmax')\n"
        "    rng = np.random.RandomState(0)\n"
        "    data = [(rng.randn(32).astype('float32'), int(rng.randint(2)))\n"
        "            for _ in range(32)]\n"
        "    return {'cost': L.classification_cost(y, lab),\n"
        "            'optimizer': optim.Momentum(learning_rate=0.01),\n"
        "            'train_reader': lambda: iter([data[:16], data[16:]]),\n"
        "            'feeding': {'x': dense_vector(32),\n"
        "                        'lab': integer_value(2)}}\n")
    cli.main(["train", "--config", str(cfg), "--device", "cpu",
              "--save_dir", str(tmp_path / "out"), "--quant-train"])
    params, _, _, _ = load_checkpoint(str(tmp_path / "out"))
    assert set(params) == {"master", "q"}
    assert set(params["q"]) == {"['__fc_0__']['w0']"}     # 2048 >= 1024
    assert params["q"]["['__fc_0__']['w0']"]["q"].dtype == np.int8


@pytest.mark.parametrize("kw, match", [
    ({"mesh": object()}, "single-chip"),
    ({"grad_accum_steps": 2}, "grad_accum_steps"),
    ({"compute_dtype": "bfloat16"}, "compute_dtype")])
def test_int8_trainer_refuses_what_jax_refuses(kw, match):
    """The combinations the JAX trainer refuses with quant_weights=True
    (paddle_tpu/trainer/trainer.py's checks) raise its ConfigError in
    the port too; a sparse_update embedding is checked below."""
    jkw = dict(kw)
    if "compute_dtype" in jkw:
        jkw["compute_dtype"] = jnp.bfloat16
    if "mesh" in jkw:
        from paddle_tpu.parallel.mesh import single_device_mesh
        jkw["mesh"] = single_device_mesh()
    with pytest.raises(JaxConfigError, match=match):
        JaxSGD(_net(JL), update_equation=jax_optim.Momentum(),
               quant_weights=True, **jkw)
    if "compute_dtype" in kw:
        kw = dict(kw, compute_dtype=torch.bfloat16)
    with pytest.raises(ConfigError, match=match):
        SGD(_net(L), update_equation=optim.Momentum(), quant_weights=True,
            device="cpu", **kw)


def test_int8_trainer_refuses_sparse_update_embeddings():
    def net(M):
        (jax_reset_names if M is JL else L.reset_names)()
        w = M.data_layer("w", size=50, is_seq=True)
        lab = M.data_layer("lab", size=1)
        e = M.embedding_layer(w, size=8, param_attr={"sparse_update": True})
        y = M.fc_layer(M.pooling_layer(e, pooling_type=M.pooling.Max()),
                       size=2, act="softmax")
        return M.classification_cost(y, lab)

    with pytest.raises(JaxConfigError, match="sparse_update"):
        JaxSGD(net(JL), update_equation=jax_optim.Momentum(),
               quant_weights=True)
    with pytest.raises(ConfigError, match="sparse_update"):
        SGD(net(L), update_equation=optim.Momentum(), quant_weights=True,
            device="cpu")


def test_kv_scale_divides_by_a_device_tensor(np_rng):
    """quant/kv.quantize_heads divides amax by a 0-dim float32 tensor on
    the input's device (a Python-scalar divisor becomes a reciprocal's
    product in PyTorch's CUDA div), made once per device; on the CPU the
    codes and scales equal JAX's bit for bit, as before."""
    d = kvq._divisor_127(torch.device("cpu"))
    assert d.dim() == 0 and d.dtype == torch.float32 and float(d) == 127.0
    assert kvq._divisor_127(torch.device("cpu")) is d
    meta = kvq._divisor_127(torch.device("meta"))
    assert meta.device.type == "meta"
    x = (np_rng.randn(3, 7, 64) * np.exp(np_rng.randn(3, 7, 1))).astype(
        np.float32)
    x[1, 2, 16:32] = 0.0                  # an all-zero head: scale 0
    q, s = kvq.quantize_heads(torch.tensor(x), 4)
    jq, js = jax_kvq.quantize_heads(jnp.asarray(x), 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1, 2, 1] == 0
    # the same bits as the scalar division on the CPU
    want = torch.tensor(x).reshape(3, 7, 4, 16).abs().amax(-1) / 127.0
    assert torch.equal(s, want)
