"""The rest of the trainer (A9·c) against the JAX package, on the CPU:
``SGD(evaluators=)``, ``grad_accum_steps``, the pruning hooks, SIGTERM
preemption resume, the background checkpoint writer, ``merge_model`` /
``load_merged``, ``Inferencer`` / ``infer``, ``testing/gradcheck`` and
the CLI's ``time``, ``checkgrad``, ``merge_model`` and ``version`` jobs.

One small config (embedding 8 -> ``networks.simple_lstm`` of 8 with a
0.5 pruning hook on both weights -> max pool -> fc 2 softmax) serves
every test; the JAX trainer runs are shared in a module fixture."""

import json
import os
import shutil
import signal
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import evaluators as JE
from paddle_tpu import optim as jax_optim
from paddle_tpu.data import integer_value as jax_integer_value
from paddle_tpu.data import \
    integer_value_sequence as jax_integer_value_sequence
from paddle_tpu.export import quantize_params as jax_quantize_params
from paddle_tpu.testing import check_grads as jax_check_grads
from paddle_tpu.trainer import (SGD as JaxSGD, Inferencer as JaxInferencer,
                                infer as jax_infer, events as jax_events)
from paddle_tpu.trainer import checkpoint as jax_ckpt
from paddle_tpu.trainer import hooks as jax_hooks
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import evaluators as E
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import integer_value, integer_value_sequence
from paddle_tpu_torch.testing import check_grads, check_topology_grads
from paddle_tpu_torch.trainer import (SGD, Trainer, Inferencer, infer, api,
                                      cli, events, hooks)
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.trainer import _quantize_params
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.tree import tree_leaves

V, E_DIM, H, B, T = 30, 8, 8, 8, 6
N_BATCHES = 4
HOOK = {"type": "pruning", "sparsity_ratio": 0.5}
FEEDING = {"word": integer_value_sequence(V), "label": integer_value(2)}
JAX_FEEDING = {"word": jax_integer_value_sequence(V),
               "label": jax_integer_value(2)}
TOL = 1e-6


def _build(M, hook=HOOK):
    """(cost, output, label) of the config in the DSL ``M``, a fresh
    name registry; ``hook`` (or None) on both of simple_lstm's weights."""
    if M is JL:
        from paddle_tpu.layers.graph import reset_names
    else:
        reset_names = L.reset_names
    reset_names()
    word = M.data_layer("word", V, is_seq=True)
    label = M.data_layer("label", 1)

    def attr():
        return {"update_hooks": dict(hook)} if hook else None
    lstm = M.networks.simple_lstm(M.embedding_layer(word, size=E_DIM),
                                  size=H, mat_param_attr=attr(),
                                  inner_param_attr=attr())
    out = M.fc_layer(M.pooling_layer(lstm, pooling_type=M.pooling.Max),
                     size=2, act="softmax")
    return M.classification_cost(out, label), out, label


def _batch(seed):
    """B ragged (ids, label) samples; the last of length T, so every
    batch pads to T (one JAX compile)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, T + 1, B)
    lengths[-1] = T
    return [(rng.randint(0, V, n).tolist(), int(rng.randint(0, 2)))
            for n in lengths]


BATCHES = [_batch(s) for s in range(N_BATCHES)]


def _reader():
    return iter(BATCHES)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(tree):
    """A port tree (tensors, nested dicts) as numpy, leaves in order."""
    return [t.detach().numpy() for t in tree_leaves(tree)]


def _close(got, want, tol=TOL):
    for g, w in zip(_np(got) if isinstance(got, dict) else got,
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def _momentum(M):
    return M.Momentum(learning_rate=0.1, momentum=0.9)


def _port_sgd(start, **kw):
    cost, out, label = _build(L)
    return SGD(cost, parameters=start, update_equation=_momentum(optim),
               device="cpu", **kw), out, label


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer on the config from one start: (a) evaluators with
    grad_accum_steps=2 over the four batches, its parameters after each
    micro-batch, the evaluators' results after three and a pass dir
    written mid-accumulation (tick 1) there; (b) two passes with a real
    SIGTERM after pass 1's second batch (its preemption dir and meta),
    then resumed to the end."""
    tmp = tmp_path_factory.mktemp("jax")
    cost, out, label = _build(JL)
    start = _host(JL.Topology(cost).init(jax.random.PRNGKey(0)))
    jt = JaxSGD(cost, parameters=jax.tree_util.tree_map(jnp.asarray, start),
                update_equation=_momentum(jax_optim),
                evaluators=[JE.classification_error_evaluator(out, label),
                            JE.auc_evaluator(out, label)],
                grad_accum_steps=2)
    run = {"start": start, "masks": _host(jt._prune_masks), "snaps": [],
           "mid": str(tmp / "mid"), "jt": jt}

    def accum_handler(e):
        if isinstance(e, jax_events.EndIteration):
            run["snaps"].append(_host(jt.parameters))
            if e.batch_id == 2:
                run["results"] = [s.result() for s in jt.evaluators]
                jt.save(run["mid"], pass_id=0, block=True)

    jt.train(_reader, feeding=JAX_FEEDING, event_handler=accum_handler,
             log_period=0)
    jb = JaxSGD(cost, parameters=jax.tree_util.tree_map(jnp.asarray, start),
                update_equation=_momentum(jax_optim))
    pre = str(tmp / "pre")
    jb.train(_reader, num_passes=2, feeding=JAX_FEEDING, save_dir=pre,
             event_handler=_sigterm_at(1, 1), log_period=0)
    with open(os.path.join(pre, "pass-00001", "meta.json")) as f:
        run["pre_meta"] = json.load(f)
    run["pre"] = str(tmp / "pre_copy")
    shutil.copytree(pre, run["pre"])
    jb.train(_reader, num_passes=2, feeding=JAX_FEEDING, save_dir=pre,
             resume=True, log_period=0)
    run["final"] = _host(jb.parameters)
    run["jb"] = jb
    return run


def _sigterm_at(pass_id, batch_id):
    """An event handler that sends this process SIGTERM at the end of
    (pass_id, batch_id)."""
    def handler(e):
        if isinstance(e, (events.EndIteration, jax_events.EndIteration)) \
                and (e.pass_id, e.batch_id) == (pass_id, batch_id):
            assert threading.current_thread() is threading.main_thread()
            os.kill(os.getpid(), signal.SIGTERM)
    return handler


# ------------------------------------------------------------ evaluators

@pytest.fixture(scope="module")
def port_accum():
    return {}


def test_sgd_evaluators_match_jax(jax_runs, port_accum):
    """SGD(evaluators=[classification error, auc], grad_accum_steps=2)
    over the same batches: result() after three steps equals JAX's (the
    error exactly), the EndIteration extras keep JAX's shape."""
    cost, out, label = _build(L)
    tr = SGD(cost, parameters=jax_runs["start"],
             update_equation=_momentum(optim), grad_accum_steps=2,
             evaluators=[E.classification_error_evaluator(out, label),
                         E.auc_evaluator(out, label)], device="cpu")
    snaps, extras = [], []

    def handler(e):
        if isinstance(e, events.EndIteration):
            snaps.append([p.detach().clone() for p in tr._leaves])
            extras.append(e.evaluator_results)
            if e.batch_id == 2:
                port_accum["results"] = [s.result() for s in tr.evaluators]
                port_accum["mid"] = tr.save(port_accum["dir"], pass_id=0)

    port_accum["dir"] = str(jax_runs["mid"]) + "_port"
    tr.train(_reader, feeding=FEEDING, event_handler=handler, log_period=2)
    port_accum.update(trainer=tr, snaps=snaps)
    got, want = port_accum["results"], jax_runs["results"]
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], abs=TOL)
    assert sorted(extras[0]) == ["extra_0"]
    assert extras[0]["extra_0"].shape == (B, 2)
    # reset at the next pass
    tr.train(lambda: iter(BATCHES[:1]), feeding=FEEDING, log_period=0)
    assert tr.evaluators[0].state["total"] == B


# ----------------------------------------------------- grad accumulation

def test_grad_accum_matches_jax(jax_runs, port_accum):
    """grad_accum_steps=2: no update on the first micro-batch, the mean
    of two applied on the second; after four micro-batches every
    parameter within 1e-6 of JAX's, two optimizer steps taken."""
    if "trainer" not in port_accum:
        test_sgd_evaluators_match_jax(jax_runs, port_accum)
    tr, snaps = port_accum["trainer"], port_accum["snaps"]
    start = [p.numpy() for p in snaps[0]]
    masked = jax.tree_util.tree_leaves(jax_runs["snaps"][0])
    for got, want in zip(start, masked):
        np.testing.assert_array_equal(got, want)
    for i in (1, 3):
        _close([p.numpy() for p in snaps[i]], jax_runs["snaps"][i])
    assert any(not np.array_equal(a.numpy(), b)
               for a, b in zip(snaps[1], start))
    # four micro-batches, then the one of the evaluators' second pass
    assert tr.opt_state["inner"]["step"] == 2
    assert tr.opt_state["tick"] == 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mid_accumulation_pass_dir_resumes_across(jax_runs, port_accum,
                                                   direction):
    """A pass dir written after three micro-batches (tick 1, one
    gradient held) by either package, loaded by the other, and one more
    micro-batch: the parameters of the writer's fourth, within 1e-6."""
    if "trainer" not in port_accum:
        test_sgd_evaluators_match_jax(jax_runs, port_accum)
    if direction == "jax_to_port":
        tr, _, _ = _port_sgd(jax_runs["start"], grad_accum_steps=2)
        meta = tr.load(jax_runs["mid"])
        assert meta["grad_accum_steps"] == 2 and tr.opt_state["tick"] == 1
        tr.train_one_batch(BATCHES[3], feeder=FEEDING)
        _close(tr.parameters, jax_runs["snaps"][3])
    else:
        _, opt, _, meta = ckpt.load_checkpoint(port_accum["dir"])
        assert set(opt) == {"inner", "gsum", "tick"}
        assert opt["tick"].dtype == np.int32 and int(opt["tick"]) == 1
        jt = jax_runs["jt"]
        jt.load(port_accum["dir"])
        jt.train_one_batch(BATCHES[3], feeder=JAX_FEEDING)
        _close([p.numpy() for p in port_accum["snaps"][3]],
               _host(jt.parameters))


def test_accum_refusals_and_adaptation(tmp_path, jax_runs):
    """JAX's refusals (grad_accum_steps < 1; with quant_weights) and its
    _adapt_accum_state: a mid-accumulation dir into another accum value
    raises, into a non-accumulating trainer drops the held gradient."""
    with pytest.raises(ConfigError, match="grad_accum_steps must be >= 1"):
        _port_sgd(None, grad_accum_steps=0)
    with pytest.raises(ConfigError, match="grad_accum_steps > 1"):
        _port_sgd(None, grad_accum_steps=2, quant_weights=True)
    three, _, _ = _port_sgd(jax_runs["start"], grad_accum_steps=3)
    with pytest.raises(ConfigError, match="mid-accumulation"):
        three.load(jax_runs["mid"])
    plain, _, _ = _port_sgd(jax_runs["start"])
    plain.load(jax_runs["mid"])
    assert set(plain.opt_state) == {"step", "slots"}
    plain.save(str(tmp_path))
    two, _, _ = _port_sgd(jax_runs["start"], grad_accum_steps=2)
    two.load(str(tmp_path))
    assert two.opt_state["tick"] == 0 and two.opt_state["inner"]["step"] == 1


# --------------------------------------------------------------- pruning

def test_pruning_masks_and_zeros_match_jax(jax_runs, port_accum):
    """The ratio masks built from the carried-over weights equal JAX's
    bit for bit; after training every pruned entry reads exactly 0."""
    if "trainer" not in port_accum:
        test_sgd_evaluators_match_jax(jax_runs, port_accum)
    tr = port_accum["trainer"]
    fresh, _, _ = _port_sgd(jax_runs["start"])
    assert sorted(fresh._prune_masks) == sorted(jax_runs["masks"])
    for key, mask in fresh._prune_masks.items():
        for name, got in sorted(mask.items()):
            np.testing.assert_array_equal(got.numpy(),
                                          jax_runs["masks"][key][name])
            # a weight half pruned; the LSTM's bias never
            assert got.mean() == (1.0 if name == "b" else 0.5)
    for key, mask in tr._prune_masks.items():
        for p, m in zip(tree_leaves(tr.parameters[key]), tree_leaves(mask)):
            assert torch.count_nonzero(p.detach() * (1 - m)) == 0
    # a load rebuilds the masks from the loaded weights
    fresh.load(port_accum["dir"])
    for got, want in zip(_np(fresh._prune_masks),
                         _np(tr._prune_masks)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["ties", "mask_file", "hook_errors"])
def test_pruning_hooks_match_jax(tmp_path, jax_runs, case):
    if case == "ties":
        # ties at the k-th smallest |w| fall as in JAX (strictly above)
        w = np.asarray([[0.5, -0.5, 0.25, 0.0], [0.25, -0.25, 1.0, 0.5]],
                       np.float32)
        for ratio in (0.25, 0.375, 0.5, 0.6, 0.0, 1.0):
            np.testing.assert_array_equal(
                hooks._ratio_mask(torch.tensor(w), ratio).numpy(),
                np.asarray(jax_hooks._ratio_mask(jnp.asarray(w), ratio)))
    elif case == "mask_file":
        rng = np.random.RandomState(5)
        bits = (rng.rand(4 * H * E_DIM) > 0.3).astype(np.float32)
        a, b = str(tmp_path / "port.mask"), str(tmp_path / "jax.mask")
        hooks.write_mask_file(a, torch.tensor(bits))
        jax_hooks.write_mask_file(b, bits)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(jax_hooks.load_mask_file(a), bits)
        np.testing.assert_array_equal(hooks.load_mask_file(b), bits)
        hook = {"type": "pruning", "mask_filename": b}
        jcost = _build(JL, hook)[0]
        want = jax_hooks.build_masks(JL.Topology(jcost),
                                     jax.tree_util.tree_map(
                                         jnp.asarray, jax_runs["start"]))
        tr = SGD(_build(L, hook)[0], parameters=jax_runs["start"],
                 update_equation=_momentum(optim), device="cpu")
        assert sorted(tr._prune_masks) == sorted(want)
        key = next(k for k in want if "transform" in k or "fc" in k)
        np.testing.assert_array_equal(
            tr._prune_masks[key]["w0"].numpy(), np.asarray(want[key]["w0"]))
        with pytest.raises(ConfigError, match="mask size"):
            hooks.load_mask_file(b, expect_size=7)
    else:
        for hook, match in (({"type": "pruning"}, "sparsity_ratio= or"),
                            ({"type": "quantize"}, "unsupported update hook")):
            with pytest.raises(ConfigError, match=match):
                SGD(_build(L, hook)[0], update_equation=_momentum(optim),
                    device="cpu")
            with pytest.raises(JaxConfigError, match=match):
                JaxSGD(_build(JL, hook)[0],
                       update_equation=_momentum(jax_optim))


# ------------------------------------------------------------ preemption

def _params_equal(a, b):
    return all(torch.equal(x.detach(), y.detach())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_preemption_resume_is_bit_identical(tmp_path, jax_runs):
    """A real SIGTERM after pass 1's second batch: the pass ends there,
    a blocking checkpoint with JAX's meta keys (preempted, signal,
    batches_done 2) is written, the handler is put back; a fresh SGD
    resuming from it skips exactly two batches and ends bit for bit on
    the uninterrupted run's parameters and momentum."""
    whole, _, _ = _port_sgd(jax_runs["start"])
    whole.train(_reader, num_passes=2, feeding=FEEDING, log_period=0)
    prev = signal.getsignal(signal.SIGTERM)
    cut, _, _ = _port_sgd(jax_runs["start"])
    seen = []

    def handler(e):
        seen.append((type(e).__name__, getattr(e, "batch_id", None)))
        _sigterm_at(1, 1)(e)

    cut.train(_reader, num_passes=2, feeding=FEEDING, log_period=0,
              save_dir=str(tmp_path), event_handler=handler)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert seen[-2:] == [("EndIteration", 1), ("EndPass", None)]
    meta = json.loads((tmp_path / "pass-00001" / "meta.json").read_text())
    assert set(meta) == set(jax_runs["pre_meta"])
    assert (meta["preempted"], meta["batches_done"], meta["signal"]) == \
        (True, 2, int(signal.SIGTERM))
    resumed, _, _ = _port_sgd(jax_runs["start"])
    began = []
    resumed.train(_reader, num_passes=2, feeding=FEEDING, log_period=0,
                  save_dir=str(tmp_path), resume=True,
                  event_handler=lambda e: began.append(
                      (e.pass_id, e.batch_id))
                  if isinstance(e, events.BeginIteration) else None)
    assert began == [(1, 2), (1, 3)]
    assert _params_equal(resumed.parameters, whole.parameters)
    assert _params_equal(resumed.opt_state["slots"],
                         whole.opt_state["slots"])
    assert resumed.opt_state["step"] == whole.opt_state["step"] == 8


def test_preemption_dir_resumes_across_packages(tmp_path, jax_runs):
    """JAX's preemption dir resumed by the port, and the port's by
    JAX: each ends within 1e-6 of the writer's uninterrupted run."""
    port, _, _ = _port_sgd(jax_runs["start"])
    save = str(tmp_path / "from_jax")
    shutil.copytree(jax_runs["pre"], save)
    port.train(_reader, num_passes=2, feeding=FEEDING, save_dir=save,
               resume=True, log_period=0)
    _close(port.parameters, jax_runs["final"])
    cut, _, _ = _port_sgd(jax_runs["start"])
    mine = str(tmp_path / "from_port")
    cut.train(_reader, num_passes=2, feeding=FEEDING, log_period=0,
              save_dir=mine, event_handler=_sigterm_at(1, 1))
    jb = jax_runs["jb"]
    jb.train(_reader, num_passes=2, feeding=JAX_FEEDING, save_dir=mine,
             resume=True, log_period=0)
    whole, _, _ = _port_sgd(jax_runs["start"])
    whole.train(_reader, num_passes=2, feeding=FEEDING, log_period=0)
    _close(whole.parameters, _host(jb.parameters))


# ------------------------------------------------------ background writer

def test_background_writer(tmp_path, monkeypatch):
    """block=False: the pass dir lands by wait_pending and equals the
    snapshot even though the next in-place step ran during the write;
    a failed write leaves no pass dir and re-raises at the next wait;
    train's pass-end saves are landed when it returns."""
    tr, _, _ = _port_sgd(None)
    tr.train_one_batch(BATCHES[0], feeder=FEEDING)
    snap = [a.copy() for a in _np(tr.parameters)]
    gate = threading.Event()
    real = np.savez

    def slow(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(np, "savez", slow)
    path = tr.save(str(tmp_path / "a"), pass_id=0, block=False)
    tr.train_one_batch(BATCHES[1], feeder=FEEDING)   # in place, meanwhile
    gate.set()
    ckpt.wait_pending(str(tmp_path / "a"))
    params, _, _, _ = ckpt.load_checkpoint(os.path.dirname(path))
    for got, want in zip(jax.tree_util.tree_leaves(params), snap):
        np.testing.assert_array_equal(got, want)
    assert not all(np.array_equal(a, b)
                   for a, b in zip(_np(tr.parameters), snap))

    calls = []

    def broken(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full")
        return real(*a, **kw)

    monkeypatch.setattr(np, "savez", broken)
    bad = tmp_path / "b"
    tr.save(str(bad), pass_id=3, block=False)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_pending(str(bad))
    assert os.listdir(bad) == []
    ckpt.wait_pending(str(bad))         # the failure is reported once
    monkeypatch.setattr(np, "savez", real)
    tr.train(_reader, num_passes=2, feeding=FEEDING, log_period=0,
             save_dir=str(tmp_path / "c"))
    assert sorted(os.listdir(tmp_path / "c")) == ["pass-00000", "pass-00001"]


def test_host_snapshot_is_a_copy():
    """``_host`` copies CPU tensors: the optimizers update in place."""
    t = torch.ones(4)
    snap = ckpt._host({"w": t})["w"]
    t.add_(1.0)
    np.testing.assert_array_equal(snap, np.ones(4, np.float32))


def test_merge_model_across_packages(tmp_path, jax_runs):
    tr, _, _ = _port_sgd(jax_runs["start"])
    tr.save(str(tmp_path / "port"), pass_id=2)
    out = ckpt.merge_model(str(tmp_path / "port"), str(tmp_path / "p.npz"))
    params, state, meta = jax_ckpt.load_merged(out)
    assert meta["pass_id"] == 2 and state == {} or state is None
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         _np(tr.parameters)):
        np.testing.assert_array_equal(np.asarray(got), want)
    jb = jax_runs["jb"]
    jb.save(str(tmp_path / "jax"), pass_id=5, block=True)
    jax_ckpt.merge_model(str(tmp_path / "jax"), str(tmp_path / "j.npz"))
    params, _, meta = ckpt.load_merged(str(tmp_path / "j.npz"))
    assert meta["pass_id"] == 5
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(_host(jb.parameters))):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- inference

def _infer_feeds():
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu.data.feeder import DataFeeder as JaxFeeder
    return (DataFeeder(FEEDING, device="cpu")(BATCHES[1]),
            JaxFeeder(JAX_FEEDING)(BATCHES[1]))


@pytest.mark.parametrize("mode, tol", [("float32", 1e-6), ("bfloat16", 4e-3),
                                       ("int8", 1e-6)])
def test_inferencer_matches_jax(jax_runs, mode, tol):
    """Inferencer at float32, under compute_dtype=bf16 (float32 outputs)
    and over int8 weights, against JAX's on the same weights and batch;
    the int8 codes and scales equal JAX's export.quantize_params."""
    start = jax_runs["start"]
    kw, jkw = {}, {}
    if mode == "bfloat16":
        kw, jkw = ({"compute_dtype": torch.bfloat16},
                   {"compute_dtype": jnp.bfloat16})
    elif mode == "int8":
        kw = jkw = {"quantize": "int8"}
    tf, jf = _infer_feeds()
    got = Inferencer(_build(L)[1], start, device="cpu", **kw).infer(tf)
    want = JaxInferencer(_build(JL)[1], jax.tree_util.tree_map(
        jnp.asarray, start), **jkw).infer(jf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    if mode == "int8":
        q, deq = _quantize_params(jax.tree_util.tree_map(torch.tensor,
                                                         start), min_size=8)
        jq, _ = jax_quantize_params(jax.tree_util.tree_map(jnp.asarray,
                                                           start), min_size=8)
        assert any("__int8__" in leaf for tree in q.values()
                   for leaf in tree.values() if isinstance(leaf, dict))
        for key in start:
            for name in start[key]:
                g, w = q[key][name], jq[key][name]
                if isinstance(w, dict):
                    for part in w:
                        np.testing.assert_array_equal(g[part].numpy(),
                                                      np.asarray(w[part]))
                else:
                    assert not isinstance(g, dict)


def test_infer_and_api(jax_runs):
    """trainer.infer and trainer.api.infer on host samples with feeding=,
    against JAX's infer; api.init sets the known FLAGS keys, ignores
    unknown ones and returns FLAGS, as JAX's; Trainer is SGD."""
    start = jax_runs["start"]
    want = np.asarray(jax_infer(_build(JL)[1], jax.tree_util.tree_map(
        jnp.asarray, start), BATCHES[2], feeding=JAX_FEEDING))
    got = infer(_build(L)[1], start, BATCHES[2], feeding=FEEDING,
                device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    got = api.infer(output_layer=_build(L)[1], parameters=start,
                    input=BATCHES[2], feeding=FEEDING, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    from paddle_tpu.trainer import api as jax_api
    from paddle_tpu.utils.flags import FLAGS as JAX_FLAGS
    from paddle_tpu_torch.utils.flags import FLAGS
    saved = (FLAGS.log_period, JAX_FLAGS.log_period)
    try:
        got = api.init(log_period=7, no_such_flag=1)
        want = jax_api.init(log_period=7, no_such_flag=1)
        assert got is FLAGS and want is JAX_FLAGS
        assert got.log_period == want.log_period == 7
        assert not hasattr(got, "no_such_flag")
    finally:
        FLAGS.log_period, JAX_FLAGS.log_period = saved
    assert Trainer is SGD


# -------------------------------------------------------------- gradcheck

def test_check_grads_matches_jax():
    """check_grads on the same function and values as JAX's: the same
    leaves (keystr paths), the same sampled elements (RandomState(0)),
    errors within 1e-6, and a wrong gradient caught."""
    rng = np.random.RandomState(1)
    params = {"a": {"w": rng.randn(3, 4)}, "b": rng.randn(4)}

    def jloss(p):
        return jnp.sum(jnp.tanh(jnp.ones(3) @ p["a"]["w"] + p["b"]) ** 2)

    def loss(p):
        return torch.sum(torch.tanh(torch.ones(3, dtype=torch.float64)
                                    @ p["a"]["w"] + p["b"]) ** 2)
    jax.config.update("jax_enable_x64", True)
    try:
        want = jax_check_grads(jloss, jax.tree_util.tree_map(jnp.asarray,
                                                             params))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = check_grads(loss, jax.tree_util.tree_map(torch.tensor, params))
    assert [(p, ok) for p, _, ok in got] == [(p, ok) for p, _, ok in want]
    np.testing.assert_allclose([e for _, e, _ in got],
                               [e for _, e, _ in want], atol=1e-6)

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            return 2 * g

    with pytest.raises(AssertionError, match="gradient mismatches"):
        check_grads(lambda p: torch.sum(Wrong.apply(p["b"]) ** 2),
                    {"b": torch.tensor(rng.randn(4))})


# -------------------------------------------------------------------- CLI

CLI_CONFIG = """\
import numpy as np
from paddle_tpu_torch import layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import integer_value, integer_value_sequence

def get_config():
    L.reset_names()
    word = L.data_layer("word", 30, is_seq=True)
    label = L.data_layer("label", 1)
    lstm = L.networks.simple_lstm(L.embedding_layer(word, size=8), size=8)
    out = L.fc_layer(L.pooling_layer(lstm, pooling_type=L.pooling.Avg),
                     size=2, act="softmax")
    rng = np.random.RandomState(0)
    data = [[(rng.randint(0, 30, rng.randint(1, 7)).tolist(),
              int(rng.randint(0, 2))) for _ in range(8)] for _ in range(4)]
    return {"cost": L.classification_cost(out, label),
            "optimizer": optim.Momentum(learning_rate=0.1, momentum=0.9),
            "train_reader": lambda: iter(data),
            "feeding": {"word": integer_value_sequence(30),
                        "label": integer_value(2)}}
"""


@pytest.mark.parametrize("job", ["time", "checkgrad", "merge_model",
                                 "version"])
def test_cli_jobs_on_the_cpu(tmp_path, capsys, job):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(CLI_CONFIG)
    base = ["--config", str(cfg), "--device", "cpu"]
    if job == "time":
        assert cli.main(["time", *base, "--num_batches", "3",
                         "--warmup", "1"]) == 0
        assert capsys.readouterr().out.startswith("time: 3 batches  min=")
        assert cli.main(["time", *base, "--warmup", "4"]) == 2
    elif job == "checkgrad":
        assert cli.main(["checkgrad", *base]) == 0
        out = capsys.readouterr().out
        assert out.endswith("checkgrad PASSED\n") and "MISMATCH" not in out
        assert cli.main(["checkgrad", *base, "--eps", "3.0"]) == 1
        assert capsys.readouterr().out.endswith("checkgrad FAILED\n")
    elif job == "merge_model":
        save = tmp_path / "out"
        assert cli.main(["train", *base, "--save_dir", str(save),
                         "--grad_accum_steps", "2"]) == 0
        assert cli.main(["merge_model", "--model_dir", str(save), "--out",
                         str(tmp_path / "m.npz"), "--device", "cpu"]) == 0
        params, _, meta = ckpt.load_merged(str(tmp_path / "m.npz"))
        want, opt, _, _ = ckpt.load_checkpoint(str(save))
        assert meta["grad_accum_steps"] == 2 and int(opt["tick"]) == 0
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    else:
        assert cli.main(["version", "--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out == [f"paddle_tpu_torch 0.1.0 (torch {torch.__version__})",
                       "devices: cpu"]


def test_check_topology_grads_on_the_config():
    """check_topology_grads over the config's cost with an average pool
    (a max pool's kinks sit within JAX's default eps of 1e-3 at this
    width, in float32) on the CPU: every leaf within JAX's default rtol,
    the LSTM's plain version on the analytic side."""
    L.reset_names()
    lstm = L.networks.simple_lstm(L.embedding_layer(
        L.data_layer("word", V, is_seq=True), size=E_DIM), size=H)
    cost = L.classification_cost(L.fc_layer(L.pooling_layer(
        lstm, pooling_type=L.pooling.Avg), size=2, act="softmax"),
        L.data_layer("label", 1))
    from paddle_tpu_torch.data import DataFeeder
    feed = DataFeeder(FEEDING, device="cpu")(BATCHES[0])
    results = check_topology_grads(L.Topology(cost), feed, device="cpu")
    shapes = L.Topology(cost).param_shapes()
    assert len(results) == sum(len(leaves) for leaves in shapes.values())
    assert all(ok for _, _, ok in results)
