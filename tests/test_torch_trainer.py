"""The port's layer DSL, trainer, data path, checkpoints and CLI
(paddle_tpu_torch.layers / .trainer / .data) against the JAX package's,
on the CPU, at a small size (vocab 50, embedding 16, h 128, B 8, T 12).

The same config is built with both DSLs (``paddle_tpu.layers`` and
``paddle_tpu_torch.layers``), the JAX ``Topology.init`` weights carried
into the port with ``params_from_numpy``, and the same batches fed to
both.  Tolerances: forward costs at rtol 1e-5 / atol 1e-6 (float32 in
other summation orders through 12 recurrent steps); three Momentum
steps within 1e-4 of each leaf's largest entry, as
tests/test_torch_lstm_blocked.py holds the bench steps.
"""

import functools
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.data import integer_value as jax_integer_value
from paddle_tpu.data import \
    integer_value_sequence as jax_integer_value_sequence
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data import (DataFeeder, dense_vector, integer_value,
                                   integer_value_sequence, reader)
from paddle_tpu_torch.models import text_rnn
from paddle_tpu_torch.ops.kernels import simple_rnn as krnn
from paddle_tpu_torch.scripts import bench
from paddle_tpu_torch.trainer import SGD, Inferencer, cli, events, infer
from paddle_tpu_torch.trainer.checkpoint import load_checkpoint
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

V, E, H, B, T = 50, 16, 128, 8, 12
ATOL, RTOL = 1e-6, 1e-5


def _rnn_stack(M, x, reverse=False):
    for _ in range(2):
        x = M.recurrent_layer(M.fc_layer(x, size=H, act=None,
                                         bias_attr=False),
                              act="tanh", reverse=reverse)
    return x


def _lstm(M, x):
    return M.lstmemory(M.fc_layer(x, size=4 * H, act=None, bias_attr=False))


def _gru(M, x):
    return M.grumemory(M.fc_layer(x, size=3 * H, act=None, bias_attr=False))


def _two_way(M, x):
    return M.concat_layer([_rnn_stack(M, x), _rnn_stack(M, x, reverse=True)])


# name -> (sequence body, pooling); the pooling is a pooling_layer type
# or the name of a whole-sequence pick
NETS = {
    "rnn_max": (_rnn_stack, "max"),
    "rnn_reverse_avg": (functools.partial(_rnn_stack, reverse=True), "avg"),
    "lstm_sum": (_lstm, "sum"),
    "gru_last": (_gru, "last_seq"),
    "concat_first": (_two_way, "first_seq"),
}


def _build(M, net):
    """The cost of ``net`` in the DSL ``M`` (the JAX or the port's),
    with a fresh name registry.  Returns (cost, pooled layer)."""
    if M is JL:
        from paddle_tpu.layers.graph import reset_names
    else:
        reset_names = L.reset_names
    reset_names()
    body, pool = NETS[net]
    word = M.data_layer("word", V, is_seq=True)
    label = M.data_layer("label", 1)
    seq = body(M, M.embedding_layer(word, size=E))
    pooled = (getattr(M, pool)(seq) if pool in ("last_seq", "first_seq")
              else M.pooling_layer(seq, pooling_type=getattr(
                  M.pooling, {"max": "Max", "avg": "Avg",
                              "sum": "Sum"}[pool])))
    out = M.fc_layer(pooled, size=2, act="softmax")
    return M.classification_cost(out, label), pooled


def _batch(seed, zero_row=True):
    """A host batch of B (ids, label) samples, ragged, one row empty."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, T + 1, B)
    if zero_row:
        lengths[0] = 0
    lengths[-1] = T
    return [(rng.randint(0, V, n).tolist(), int(rng.randint(0, 2)))
            for n in lengths]


FEEDING = {"word": integer_value_sequence(V), "label": integer_value(2)}
JAX_FEEDING = {"word": jax_integer_value_sequence(V),
               "label": jax_integer_value(2)}


def _feeds(batch):
    tf = DataFeeder(FEEDING, device="cpu")(batch)
    ids, lab = tf["word"], tf["label"]
    jf = {"word": JaxSeq(jnp.asarray(ids.data.numpy()),
                         jnp.asarray(ids.lengths.numpy())),
          "label": jnp.asarray(lab.numpy())}
    return tf, jf


@functools.lru_cache(maxsize=None)
def _jax_net(net):
    """The JAX topology's init (seed 0) as numpy and its cost and pooled
    values on batch 0, once per net."""
    cost, pooled = _build(JL, net)
    topo = JL.Topology(cost)
    params = topo.init(jax.random.PRNGKey(0))
    _, jf = _feeds(_batch(0))
    c, p = topo.apply(params, jf, mode="test", extra_outputs=[pooled])
    return (jax.tree_util.tree_map(np.asarray, params), np.asarray(c),
            np.asarray(p), [n.name for n in topo.order])


@pytest.mark.parametrize("net", sorted(NETS))
def test_graph_forward_and_cost_match_jax(net):
    """The port's graph on the JAX weights (params_from_numpy) gives the
    JAX Topology.apply's per-sample cost and pooled vector; both DSLs mint
    the same layer names and parameter keys."""
    tree, want_cost, want_pooled, want_order = _jax_net(net)
    cost, pooled = _build(L, net)
    topo = L.Topology(cost)
    assert [n.name for n in topo.order] == want_order
    assert topo.param_shapes() == {
        k: {n: a.shape for n, a in v.items()} for k, v in tree.items()}
    params = L.params_from_numpy(topo, tree, device="cpu")
    tf, _ = _feeds(_batch(0))
    krnn.launches_fwd = 0
    with torch.no_grad():
        c, p = topo.apply(params, tf, mode="test", extra_outputs=[pooled])
    np.testing.assert_allclose(c.numpy(), want_cost, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p.numpy(), want_pooled, rtol=RTOL, atol=ATOL)
    assert krnn.launches_fwd == 0      # the CPU takes the plain versions


def test_params_from_numpy_refuses_a_tree_of_another_config():
    tree = _jax_net("rnn_max")[0]
    cost, _ = _build(L, "lstm_sum")
    with pytest.raises(ValueError, match="does not fit"):
        L.params_from_numpy(L.Topology(cost), tree, device="cpu")


def _jax_sgd_steps(fused, batches):
    """The JAX trainer from the JAX init, three train_one_batch steps with
    its fused route forced on (Pallas in interpret mode) or off (the
    scan): (initial params, losses, params, momentum) as numpy."""
    cost, _ = _build(JL, "rnn_max")
    trainer = JaxSGD(cost, update_equation=jax_optim.Momentum(
        learning_rate=0.01, momentum=0.9), seed=3)
    start = jax.tree_util.tree_map(np.asarray, trainer.parameters)
    prior, count = jax_rnn.FUSED_LSTM, jax_rnn.FUSED_DISPATCH_COUNT
    jax_rnn.FUSED_LSTM = "always" if fused else "0"
    try:
        losses = [float(trainer.train_one_batch(b, feeder=JAX_FEEDING))
                  for b in batches]
    finally:
        jax_rnn.FUSED_LSTM = prior
    assert (jax_rnn.FUSED_DISPATCH_COUNT - count == 2) == fused
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (start, losses, host(trainer.parameters),
            host(trainer.opt_state["slots"]["mom"]))


@pytest.fixture(scope="module")
def three_steps():
    batches = [_batch(s) for s in (1, 2, 3)]
    return batches, {fused: _jax_sgd_steps(fused, batches)
                     for fused in (True, False)}


@pytest.mark.parametrize("fused", [True, False], ids=["jax_fused",
                                                      "jax_scan"])
def test_sgd_steps_match_jax_trainer(three_steps, fused):
    """Three SGD.train_one_batch Momentum steps against
    paddle_tpu.trainer.SGD's on the same batches from the same weights:
    losses, every param and momentum leaf."""
    batches, runs = three_steps
    start, want_losses, want_params, want_mom = runs[fused]
    cost, _ = _build(L, "rnn_max")
    trainer = SGD(cost, parameters=start, update_equation=optim.Momentum(
        learning_rate=0.01, momentum=0.9), device="cpu")
    losses = [float(trainer.train_one_batch(b, feeder=FEEDING))
              for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert trainer.opt_state["step"] == 3
    for got, want in zip(
            tree_leaves(trainer.parameters)
            + tree_leaves(trainer.opt_state["slots"]["mom"]),
            jax.tree_util.tree_leaves(want_params)
            + jax.tree_util.tree_leaves(want_mom)):
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max()


def _port_trainer(seed=1, net="rnn_max"):
    return SGD(_build(L, net)[0], update_equation=optim.Momentum(
        learning_rate=0.01, momentum=0.9), seed=seed, device="cpu")


def test_train_emits_events_and_tests():
    """SGD.train over two passes of a three-batch reader: the event
    stream in order, a cost per iteration, the test cost each pass equal
    to SGD.test on the trained weights."""
    data = [s for seed in (4, 5, 6) for s in _batch(seed)]
    train_reader = reader.batch(lambda: iter(data), B)
    test_reader = reader.batch(lambda: iter(_batch(7)), B)
    trainer = _port_trainer()
    seen = []

    def handler(e):
        seen.append(e)

    trainer.train(train_reader, num_passes=2, event_handler=handler,
                  feeding=FEEDING, test_reader=test_reader, log_period=2)
    kinds = [type(e).__name__ for e in seen]
    one_pass = (["BeginPass"] + ["BeginIteration", "EndIteration"] * 3
                + ["EndTesting", "EndPass"])
    assert kinds == one_pass * 2
    ends = [e for e in seen if isinstance(e, events.EndIteration)]
    assert [(e.pass_id, e.batch_id) for e in ends] == [
        (p, b) for p in (0, 1) for b in range(3)]
    assert all(np.isfinite(float(e.cost)) for e in ends)
    tested = [e.cost for e in seen if isinstance(e, events.EndTesting)]
    assert tested[-1] == pytest.approx(trainer.test(test_reader,
                                                    feeding=FEEDING))
    assert trainer.opt_state["step"] == 6


def test_train_extra_layers_ride_on_events():
    cost, pooled = _build(L, "rnn_max")
    trainer = SGD(cost, update_equation=optim.Momentum(learning_rate=0.01),
                  extra_layers=[pooled], device="cpu")
    got = []
    trainer.train(reader.batch(lambda: iter(_batch(8)), B),
                  event_handler=lambda e: got.append(e), feeding=FEEDING,
                  buffered_batches=0)
    extra = [e for e in got if isinstance(e, events.EndIteration)][0]
    assert extra.evaluator_results["extra_0"].shape == (B, H)


def test_cli_train_writes_a_pass_dir_and_test_reads_it(tmp_path, capsys):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from paddle_tpu_torch.models import text_rnn\n"
        "def get_config():\n"
        "    return text_rnn.config(seed=int(CONFIG_ARGS['seed']), "
        "n_batches=2, batch=8, seq_len=12, vocab=50, hidden=128)\n")
    save = tmp_path / "out"
    assert cli.main(["train", "--config", str(cfg), "--config_args",
                     "seed=3", "--device", "cpu", "--num_passes", "2",
                     "--save_dir", str(save), "--save_only_one"]) == 0
    assert sorted(os.listdir(save)) == ["pass-00001"]
    assert sorted(os.listdir(save / "pass-00001")) == [
        "meta.json", "model_state.npz", "opt_state.npz", "params.npz"]
    meta = json.loads((save / "pass-00001" / "meta.json").read_text())
    assert meta["pass_id"] == 1 and meta["format_version"] == 1
    params, opt_state, _, _ = load_checkpoint(str(save))
    assert int(opt_state["step"]) == 4
    assert set(params) == set(L.Topology(text_rnn.build(
        vocab=50, hidden=128)).param_shapes())
    capsys.readouterr()
    assert cli.main(["test", "--config", str(cfg), "--config_args",
                     "seed=3", "--device", "cpu", "--model_dir",
                     str(save)]) == 0
    assert capsys.readouterr().out.startswith("test cost: ")


def test_cli_refuses_a_v1_config(tmp_path):
    """A v1 config runs through the config compiler now
    (tests/test_torch_compat.py); one that declares no outputs() is
    refused by both CLIs."""
    from paddle_tpu.trainer import cli as jax_cli
    from paddle_tpu.utils.error import ConfigError as JaxConfigError
    cfg = tmp_path / "no_outputs.py"
    cfg.write_text("from paddle.trainer_config_helpers import *\n"
                   "settings(batch_size=8)\n")
    with pytest.raises(ConfigError, match="declared no outputs"):
        cli.main(["train", "--config", str(cfg), "--device", "cpu"])
    with pytest.raises(JaxConfigError, match="declared no outputs"):
        jax_cli.main(["train", "--config", str(cfg)])


def test_a_jax_trainers_pass_dir_loads_in_the_port(tmp_path):
    """paddle_tpu.trainer.SGD trains two steps and saves; the port's
    SGD.load reads the pass dir (params, momentum, step) and its forward
    equals the JAX trainer's on the same batch."""
    cost, _ = _build(JL, "gru_last")
    jt = JaxSGD(cost, update_equation=jax_optim.Momentum(
        learning_rate=0.01, momentum=0.9))
    for seed in (9, 10):
        jt.train_one_batch(_batch(seed), feeder=JAX_FEEDING)
    jt.save(str(tmp_path), pass_id=4, block=True)
    tf, jf = _feeds(_batch(11))
    want = np.asarray(jt.topology.apply(jt.parameters, jf, mode="test"))
    port = _port_trainer(net="gru_last")
    meta = port.load(str(tmp_path))
    assert meta["pass_id"] == 4 and port.opt_state["step"] == 2
    for got, ref in zip(tree_leaves(port.opt_state["slots"]["mom"]),
                        jax.tree_util.tree_leaves(
                            jt.opt_state["slots"]["mom"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with torch.no_grad():
        got = port.topology.apply(port.parameters, tf, mode="test")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_save_load_round_trip_is_bit_for_bit(tmp_path):
    trainer = _port_trainer()
    trainer.train_one_batch(_batch(12), feeder=FEEDING)
    path = trainer.save(str(tmp_path), pass_id=0)
    assert os.path.basename(path) == "pass-00000"
    other = _port_trainer(seed=5)
    other.load(str(tmp_path), pass_id=0)
    for a, b in zip(tree_leaves(trainer.parameters)
                    + tree_leaves(trainer.opt_state["slots"]["mom"]),
                    tree_leaves(other.parameters)
                    + tree_leaves(other.opt_state["slots"]["mom"])):
        assert torch.equal(a.detach(), b.detach())
    assert other.opt_state["step"] == 1
    assert all(p.requires_grad for p in other._leaves)
    # resume continues after the latest pass dir
    seen = []
    other.train(reader.batch(lambda: iter(_batch(13)), B), num_passes=2,
                event_handler=lambda e: seen.append(e), feeding=FEEDING,
                save_dir=str(tmp_path), resume=True)
    assert [e.pass_id for e in seen if isinstance(e, events.BeginPass)] \
        == [1]


def test_feeder_packs_sequences_and_dense_slots():
    feeder = DataFeeder({"w": integer_value_sequence(V),
                         "x": dense_vector(3),
                         "y": integer_value(2)},
                        bucket_bounds=[8, 16], pad_batch_to=3,
                        device="cpu")
    feed = feeder([([1, 2, 3], [0.5, 1.0, 2.0], 1),
                   ([4], [1.0, 0.0, 0.0], 0)])
    assert isinstance(feed["w"], SequenceBatch)
    assert feed["w"].data.shape == (3, 8) and feed["w"].data.dtype \
        == torch.int32
    assert feed["w"].lengths.tolist() == [3, 1, 1]
    assert feed["w"].data[0, :4].tolist() == [1, 2, 3, 0]
    assert feed["x"].shape == (3, 3) and feed["x"].dtype == torch.float32
    assert feed["y"].tolist() == [1, 0, 0]


@pytest.mark.parametrize("kw, item", [
    ({"mesh": object()}, "A12"), ({"sharding_rules": object()}, "A12"),
    # evaluators train now (tests/test_torch_trainer_a9c.py); int8
    # weights on a mesh JAX's trainer refuses too
    ({"quant_weights": True, "mesh": object()}, "single-chip"),
    # bf16 compute trains now (tests/test_torch_dtypes.py); beside int8
    # weight streaming JAX's trainer refuses it too
    ({"compute_dtype": torch.bfloat16, "quant_weights": True},
     "compute_dtype"),
    # gradient accumulation trains now (tests/test_torch_trainer_a9c.py);
    # fewer than one micro-batch JAX's trainer refuses too
    ({"grad_accum_steps": 0}, "grad_accum_steps must be >= 1"),
    # int8 training runs now (tests/test_torch_trainer_quant.py); with
    # gradient accumulation JAX's trainer refuses it too
    ({"quant_weights": True, "grad_accum_steps": 2}, "quant_weights")])
def test_sgd_refuses_settings_not_ported(kw, item):
    with pytest.raises(ConfigError, match=item):
        SGD(_build(L, "rnn_max")[0], update_equation=optim.Momentum(),
            device="cpu", **kw)


def test_refusals_of_the_graph_and_the_train_loop(tmp_path):
    L.reset_names()
    word = L.data_layer("word", V, is_seq=True)
    label = L.data_layer("label", 1)
    # sparse embeddings train now (tests/test_torch_sparse.py); one fed
    # from a non-data layer JAX's trainer refuses too
    sparse = L.embedding_layer(L.fc_layer(word, size=1, act=None), size=E,
                               sparse_update=True)
    out = L.fc_layer(L.pooling_layer(sparse), size=2, act="softmax")
    with pytest.raises(ConfigError,
                       match="sparse_update.*needs a data layer input"):
        SGD(L.classification_cost(out, label),
            update_equation=optim.Momentum(), device="cpu")
    # pruning trains now (tests/test_torch_trainer_a9c.py); a hook with
    # neither a ratio nor a mask file JAX's trainer refuses too
    hooked = L.fc_layer(L.pooling_layer(L.embedding_layer(word, size=E)),
                        size=2, act="softmax",
                        param_attr={"update_hooks": [{"type": "pruning"}]})
    with pytest.raises(ConfigError,
                       match="needs sparsity_ratio= or mask_filename="):
        SGD(L.classification_cost(hooked, label),
            update_equation=optim.Momentum(), device="cpu")
    # the carry runs now (tests/test_torch_prev_batch.py); on a reversed
    # layer JAX refuses it too
    with pytest.raises(ConfigError, match="prev_batch_state"):
        L.recurrent_layer(L.fc_layer(word, size=H), reverse=True,
                          prev_batch_state=True)
    trainer = _port_trainer()
    rd = reader.batch(lambda: iter(_batch(14)), B)
    # prefetch trains now (tests/test_torch_data_a9f.py); a negative depth
    # JAX's prefetcher refuses too
    with pytest.raises(ValueError, match="prefetch depth must be >= 1"):
        trainer.train(rd, feeding=FEEDING, prefetch=-1)
    # save_on_signal trains now (tests/test_torch_trainer_a9c.py); a
    # resume without a save_dir JAX's trainer refuses too
    with pytest.raises(ConfigError, match="needs save_dir"):
        trainer.train(rd, feeding=FEEDING, save_on_signal=True, resume=True)
    # a preemption checkpoint resumes now; one written mid-accumulation
    # under another grad_accum_steps JAX's trainer refuses too
    two = SGD(_build(L, "rnn_max")[0], update_equation=optim.Momentum(),
              grad_accum_steps=2, device="cpu")
    two.train_one_batch(_batch(14), feeder=FEEDING)
    path = two.save(str(tmp_path), pass_id=2,
                    extra={"preempted": True, "batches_done": 1})
    three = SGD(_build(L, "rnn_max")[0], update_equation=optim.Momentum(),
                grad_accum_steps=3, device="cpu")
    with pytest.raises(ConfigError, match="mid-accumulation"):
        three.train(rd, feeding=FEEDING, save_dir=os.path.dirname(path),
                    resume=True)
    # precomputed= serves the recurrent_group hoist now
    # (tests/test_torch_recurrent_group.py): a node's value is taken as
    # it is
    cost = trainer.topology.outputs[0]
    value = torch.arange(3.0)
    feed = DataFeeder(FEEDING, device="cpu")(_batch(14))
    assert trainer.topology.apply(trainer.parameters, feed,
                                  precomputed={cost.name: value}) is value


def test_entry_points_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SGD(_build(L, "rnn_max")[0], update_equation=optim.Momentum())
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from paddle_tpu_torch.models import text_rnn\n"
                   "def get_config():\n"
                   "    return text_rnn.config(n_batches=1, batch=8, "
                   "seq_len=4, vocab=50, hidden=128)\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--config", str(cfg)])
    for job in (["time", "--config", str(cfg)],
                ["checkgrad", "--config", str(cfg)],
                ["merge_model", "--model_dir", str(tmp_path), "--out",
                 str(tmp_path / "m.npz")], ["version"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(job)
    cost, pooled = _build(L, "rnn_max")
    params = L.Topology(cost).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Inferencer(pooled, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer(pooled, params, _batch(1), feeding=FEEDING)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_rnn(batch=8, seq_len=4, hidden=128, vocab=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataFeeder(FEEDING)


def test_bench_rnn_trains_on_the_cpu_through_the_dsl():
    """bench_rnn at a small size: the slice's model (both layers admitted
    by the fused rule), the loss finite, no launch counted on the CPU."""
    krnn.launches_fwd = krnn.launches_bwd = 0
    run = bench.bench_rnn(batch=8, seq_len=12, hidden=128, vocab=50,
                          n_batches=2, device="cpu")
    assert krnn.supported(8, 128, "tanh", None)
    losses = [float(run.train_step()) for _ in range(3)]
    assert all(np.isfinite(losses))
    assert run.trainer.opt_state["step"] == 3
    assert (krnn.launches_fwd, krnn.launches_bwd) == (0, 0)
    # bench.py's convention: 3 x the two layers' forward products, with
    # the config's embedding width 128
    assert run.flops_per_step == 3 * 2 * 8 * 12 * 128 * (128 + 3 * 128)
