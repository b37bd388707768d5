"""The port's fault injection (``paddle_tpu_torch/resilience/faults.py``)
and the fault points wired into its hot paths, on the CPU:

- each spec fires on the same hits as the JAX package's (``at=``,
  ``every=`` with ``times=``, a seeded ``p=``), and bad specs raise the
  same ``ConfigError``;
- the counterparts of JAX's ``tests/test_resilience.py`` cases
  ``test_prefetch_h2d_fault_surfaces_in_consumer``,
  ``test_trainer_step_fault_then_resume_bit_identical`` (the port
  against itself, bit for bit), ``test_checkpoint_write_fault_leaves_no_
  partial`` and ``test_partial_tmp_checkpoint_never_picked_up``;
- with no supervisor, a ``serving.decode_step`` (chunked),
  ``serving.prefill`` (the ladder) or ``batcher.submit`` fault ends the
  same requests as JAX's unsupervised batcher ends them, with the same
  error types, and every other request streams the same tokens as a
  clean run of the same engine, bit for bit; ``fault_injections_total``
  renders on ``/metrics``.  Requests run one after another, so a rule's
  hit count lands on the same request in both packages.
"""

import os

import numpy as np
import pytest
import jax

import paddle_tpu.resilience.faults as jax_faults
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.serving import BatchExecutionError as JaxBatchError
from paddle_tpu.serving.decode_engine import (
    DecodeEngine as JaxEngine, GenerationBatcher as JaxBatcher)
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import dense_vector, integer_value
from paddle_tpu_torch.data.prefetch import ShardedPrefetcher, device_placer
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.resilience import FAULT_POINTS, FaultPlan, \
    InjectedFault, TransientError, faults
from paddle_tpu_torch.serving import (BatchExecutionError, DecodeEngine,
                                      GenerationBatcher, ServingMetrics)
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.trainer.checkpoint import load_checkpoint, \
    save_checkpoint
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

VOCAB, HEADS, MAX_LEN, SLOTS, BUCKETS = 64, 2, 48, 4, (8, 16)


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear()
    jax_faults.clear()


# ---------------------------------------------------------------- plans


def _pattern(mod, spec, point, n=32):
    plan = mod.FaultPlan.from_spec(spec)
    out = []
    for _ in range(n):
        try:
            plan.hit(point)
            out.append(0)
        except mod.InjectedFault as e:
            assert e.point == point
            out.append(e.hit_index)
    return out


@pytest.mark.parametrize("spec,point", [
    ("serving.decode_step:at=3", "serving.decode_step"),
    ("trainer.step:every=2,times=2", "trainer.step"),
    ("trainer.step:every=3", "trainer.step"),
    ("batcher.submit:p=0.5,seed=9,action=error", "batcher.submit"),
    ("data.prefetch.h2d:p=0.2,seed=3", "data.prefetch.h2d"),
    ("serving.prefill:at=2;batcher.submit:every=5", "serving.prefill"),
])
def test_specs_fire_on_the_same_hits_as_jax(spec, point):
    got = _pattern(faults, spec, point)
    assert got == _pattern(jax_faults, spec, point)
    assert any(got)
    assert got == _pattern(faults, spec, point)    # replays bit for bit


@pytest.mark.parametrize("spec", [
    "serving.decode_stepp:at=1", "serving.decode_step:bogus=1",
    "serving.decode_step:at=1,every=2", "serving.decode_step",
    "serving.decode_step:at", "trainer.step:at=1;trainer.step:every=2",
    "trainer.step:at=1,action=explode"])
def test_bad_specs_raise_the_same_config_error(spec):
    with pytest.raises(JaxConfigError) as want:
        jax_faults.FaultPlan.from_spec(spec)
    with pytest.raises(ConfigError) as got:
        FaultPlan.from_spec(spec)
    assert str(got.value) == str(want.value)


def test_registry_hang_and_install():
    assert FAULT_POINTS == jax_faults.FAULT_POINTS
    assert issubclass(InjectedFault, TransientError)
    faults.install_spec("trainer.step:at=1,action=hang,hang_s=0.01")
    faults.hit("trainer.step")          # hangs briefly, then returns
    assert faults.fired_counts() == {"trainer.step": 1}
    assert faults.install_spec("") is None and faults.active_plan() is None
    faults.hit("trainer.step")
    assert faults.fired_counts() == {}


# ------------------------------------------------------------ prefetch


def test_prefetch_h2d_fault_surfaces_in_consumer():
    def source():
        for i in range(4):
            yield {"x": np.full((2, 2), i, np.float32)}

    faults.install_spec("data.prefetch.h2d:at=2")
    pf = ShardedPrefetcher(source, depth=2,
                           place=device_placer(device="cpu"))
    first = next(iter(pf))
    assert float(first["x"][0, 0]) == 0.0
    with pytest.raises(InjectedFault):
        next(iter(pf))
    faults.clear()
    pf.close()


# ------------------------------------------------------------ training


def _tiny_trainer(seed=7):
    L.reset_names()
    x = L.data_layer("res_x", size=4)
    lab = L.data_layer("res_lab", size=1)
    h = L.fc_layer(input=x, size=8, act="tanh")
    y = L.fc_layer(input=h, size=2, act="softmax")
    tr = SGD(cost=L.classification_cost(y, lab),
             update_equation=optim.Momentum(learning_rate=0.1,
                                            momentum=0.9),
             seed=seed, device="cpu")
    feeding = {"res_x": dense_vector(4), "res_lab": integer_value(2)}

    def reader():
        rng = np.random.RandomState(0)      # identical batches every pass
        xs = rng.randn(24, 4).astype(np.float32)
        ys = (xs[:, 0] > 0).astype(np.int64)
        for i in range(0, 24, 8):
            yield [(xs[j], int(ys[j])) for j in range(i, i + 8)]

    return tr, feeding, reader


def test_trainer_step_fault_then_resume_bit_identical(tmp_path):
    sd = str(tmp_path / "ckpt")
    t1, feeding, reader = _tiny_trainer()
    # 3 batches a pass: hit 5 = pass 1, batch 1, after pass 0's save
    faults.install_spec("trainer.step:at=5")
    with pytest.raises(InjectedFault):
        t1.train(reader, num_passes=2, feeding=feeding, log_period=0,
                 buffered_batches=0, save_dir=sd)
    faults.clear()
    assert sorted(d for d in os.listdir(sd) if d.startswith("pass-")) \
        == ["pass-00000"]
    t2, feeding, reader = _tiny_trainer()
    t2.train(reader, num_passes=2, feeding=feeding, log_period=0,
             buffered_batches=0, save_dir=sd, resume=True)
    t3, feeding, reader = _tiny_trainer()
    t3.train(reader, num_passes=2, feeding=feeding, log_period=0,
             buffered_batches=0)
    a, b = tree_leaves(t2.parameters), tree_leaves(t3.parameters)
    assert len(a) == len(b) and all(x.equal(y) for x, y in zip(a, b)), \
        "resumed params diverged from the uninterrupted run"
    t4, feeding, reader = _tiny_trainer()
    t4.train(reader, num_passes=1, feeding=feeding, log_period=0,
             buffered_batches=0, save_dir=str(tmp_path / "fresh"),
             resume=True)


def test_checkpoint_write_fault_leaves_no_partial(tmp_path):
    params = {"w": np.arange(4, dtype=np.float32)}
    faults.install_spec("trainer.checkpoint.write:at=1")
    with pytest.raises(InjectedFault):
        save_checkpoint(str(tmp_path), 0, params, block=True)
    faults.clear()
    assert os.listdir(tmp_path) == []       # fully cleaned
    save_checkpoint(str(tmp_path), 0, params, block=True)
    p, _, _, meta = load_checkpoint(str(tmp_path))
    assert meta["pass_id"] == 0
    np.testing.assert_array_equal(np.asarray(p["w"]), params["w"])
    # the background writer: the fault surfaces at the next wait
    from paddle_tpu_torch.trainer.checkpoint import wait_pending
    faults.install_spec("trainer.checkpoint.write:at=1")
    save_checkpoint(str(tmp_path), 1, params, block=False)
    with pytest.raises(InjectedFault):
        wait_pending(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["pass-00000"]


def test_partial_tmp_checkpoint_never_picked_up(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": np.zeros(2, np.float32)},
                    block=True)
    partial = tmp_path / ".tmp-pass-00001-killed"
    partial.mkdir()
    np.savez(partial / "params.npz", w=np.ones(2, np.float32))
    _, _, _, meta = load_checkpoint(str(tmp_path))
    assert meta["pass_id"] == 0


# ------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def tree():
    return jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                       d_model=32, num_heads=HEADS, dff=64, enc_layers=2,
                       dec_layers=0, max_len=MAX_LEN)


CASES = [(np.random.RandomState(i).randint(1, VOCAB, n).astype(np.int32), 4)
         for i, n in enumerate((5, 9, 3, 12))]


def _run(batcher_cls, engine, spec, fault_mod, error_types):
    """The CASES one after another through a fresh batcher with ``spec``
    installed: per request ("ok", streamed tokens) or the error's kind."""
    bat = batcher_cls(engine)
    fault_mod.install_spec(spec)
    out = []
    try:
        for prompt, n in CASES:
            toks = []
            try:
                fut = bat.submit(prompt, max_tokens=n, on_token=toks.append)
            except fault_mod.InjectedFault:
                out.append("submit:InjectedFault")
                continue
            try:
                res = fut.result(120)
                assert res["tokens"] == toks
                out.append(("ok", toks))
            except error_types as e:
                out.append(f"result:{type(e).__name__}")
        fired = fault_mod.fired_counts()
    finally:
        fault_mod.clear()
        bat.close()
    return out, fired


@pytest.mark.parametrize("spec,chunk", [
    ("serving.decode_step:at=6", 4),
    ("serving.decode_step:every=4,times=2", 4),
    ("serving.prefill:at=2", 0),
    ("batcher.submit:at=3", 4),
])
def test_unsupervised_faults_end_the_same_requests_as_jax(tree, spec,
                                                          chunk):
    kw = dict(num_heads=HEADS, num_slots=SLOTS, max_len=MAX_LEN,
              prefill_buckets=BUCKETS, prefill_chunk=chunk)
    jeng = JaxEngine(tree, **kw)
    params = transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")
    metrics = ServingMetrics()
    eng = DecodeEngine(params, device="cpu", metrics=metrics, **kw)
    want, jfired = _run(JaxBatcher, jeng, spec, jax_faults, JaxBatchError)
    got, fired = _run(GenerationBatcher, eng, spec, faults,
                      BatchExecutionError)
    clean, _ = _run(GenerationBatcher, eng, "", faults, BatchExecutionError)
    ended = [i for i, o in enumerate(got) if isinstance(o, str)]
    assert ended == [i for i, o in enumerate(want) if isinstance(o, str)]
    assert [got[i] for i in ended] == [want[i] for i in ended]
    assert fired == jfired and sum(fired.values()) >= 1
    assert 0 < len(ended) < len(CASES)
    for i, o in enumerate(got):
        if i not in ended:
            assert o == clean[i], f"request {i} diverged from a clean run"
    # the engine kept serving, and /metrics shows the fires
    assert eng.free_slots == SLOTS
    text = metrics.render_prometheus()
    point = spec.split(":")[0]
    assert f'{metrics.name}_fault_injections_total' in text
    # fired_counts is read at render time: the plan was cleared, so
    # install it again to see the counter line
    faults.install(FaultPlan.from_spec(spec))
    for _ in range(64):
        try:
            faults.hit(point)
        except InjectedFault:
            break
    assert f'fault_injections_total{{point="{point}"}} 1' \
        in metrics.render_prometheus()
    assert metrics.snapshot()["faults_fired"] == {point: 1}
