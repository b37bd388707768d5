"""The port's process flags (``paddle_tpu_torch/utils/flags.py``) and
their readers against the JAX package's on the CPU:

- the field set and defaults equal JAX's, less the named JAX-only table
  (``JAX_ONLY``), plus ``use_gpu``, with the defaults that differ named
  in ``PORT_DEFAULTS`` (``compute_dtype``: the default ``apply()`` keeps
  the port in float32, where JAX's default is the TPU's bf16);
- the same argv parses to the same values through ``add_to_parser`` /
  ``update_from_args``; ``flags_table_md()`` has a row for every field;
- ``trainer.api.init`` and ``apply()`` (the fault plan, the tracer);
- ``use_gpu=False`` pins entry points given no device to the CPU;
- the global ``FLAGS.prev_batch_state`` carries an ``lstmemory`` /
  ``grumemory`` batch into the next as JAX's does (values within TOL =
  1e-5 of each one's largest entry) and skips reversed layers.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
import paddle_tpu.utils.flags as jax_flags
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.layers.graph import value_data as jax_value
from paddle_tpu.trainer import api as jax_api
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import device
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.graph import value_data
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.trainer import api
from paddle_tpu_torch.utils import flags

TOL = 1e-5
B, T, HID = 3, 8, 5


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.fixture
def saved_flags():
    """Restore both packages' FLAGS, the policy, the plan and the
    tracer after a test that changes them."""
    mine = dataclasses.replace(flags.FLAGS)
    theirs = dataclasses.replace(jax_flags.FLAGS)
    yield
    for live, keep in ((flags.FLAGS, mine), (jax_flags.FLAGS, theirs)):
        for f in dataclasses.fields(live):
            setattr(live, f.name, getattr(keep, f.name))
    dtypes.set_policy()
    faults.clear()
    trace.disable()


def test_fields_and_defaults_are_jaxs_less_the_jax_only_table():
    mine, theirs = _defaults(flags.Flags), _defaults(jax_flags.Flags)
    assert set(flags.JAX_ONLY) <= set(theirs)
    assert set(mine) == (set(theirs) - set(flags.JAX_ONLY)) | {"use_gpu"}
    assert [n for n in mine if n != "use_gpu"] == [
        n for n in theirs if n not in flags.JAX_ONLY]
    for name, default in mine.items():
        if name in flags.PORT_DEFAULTS:
            assert default == flags.PORT_DEFAULTS[name][0]
            assert default != theirs[name]
        elif name == "use_gpu":
            assert default is True
        else:
            assert default == theirs[name], name
    assert theirs["compute_dtype"] == "bfloat16"
    assert all(isinstance(r, str) and r for r in flags.JAX_ONLY.values())
    assert "use_gpu" not in flags.SUBSUMED
    assert set(flags.SUBSUMED) == set(jax_flags.SUBSUMED) - {"use_gpu"}


def test_the_same_argv_parses_to_the_same_values():
    import argparse
    argv = ["--log_period", "7", "--prev_batch_state", "true",
            "--serving_kv_layout", "paged", "--obs_trace_sample", "0.25",
            "--num_processes", "3", "--save_dir", "out", "--async_load_data",
            "no", "--prefetch_depth", "4", "--resilience_fault_spec",
            "trainer.step:at=2", "--checkgrad_eps", "0.01",
            "--compute_dtype", "float32"]
    got, want = flags.Flags(), jax_flags.Flags()
    for obj in (got, want):
        ap = argparse.ArgumentParser()
        obj.add_to_parser(ap)
        obj.update_from_args(ap.parse_args(argv))
    for name in _defaults(flags.Flags):
        if name != "use_gpu":
            assert getattr(got, name) == getattr(want, name), name
    assert (got.log_period, got.prev_batch_state, got.async_load_data,
            got.obs_trace_sample, got.num_processes, got.compute_dtype) \
        == (7, True, False, 0.25, 3, "float32")


def test_flags_table_has_a_row_for_every_field():
    table = flags.flags_table_md()
    rows = [line for line in table.splitlines() if line.startswith("| `--")]
    assert [r.split("`")[1] for r in rows] == [
        "--" + f.name for f in dataclasses.fields(flags.Flags)]
    assert set(flags.FLAG_DOCS) == set(_defaults(flags.Flags))


def test_api_init_follows_jaxs_reading(saved_flags):
    got = api.init(prefetch_depth=5, use_gpu=False, bogus=1)
    want = jax_api.init(prefetch_depth=5, use_tpu=False, bogus=1)
    assert got is flags.FLAGS and want is jax_flags.FLAGS
    assert got.prefetch_depth == want.prefetch_depth == 5
    assert got.use_gpu is False and want.use_tpu is False
    assert not hasattr(got, "bogus") and not hasattr(want, "bogus")
    from paddle_tpu_torch.utils import FLAGS
    assert FLAGS is flags.FLAGS


def test_use_gpu_false_pins_the_cpu(saved_flags):
    api.init(use_gpu=False)
    assert device.resolve() == torch.device("cpu")
    assert device.resolve("cpu") == torch.device("cpu")
    api.init(use_gpu=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device.resolve()


def test_default_apply_keeps_float32_and_installs_plan_and_tracer(
        saved_flags):
    dtypes.set_policy(compute_dtype="bfloat16")
    f = flags.Flags()
    f.apply()
    assert dtypes.compute_dtype() == torch.float32
    assert faults.active_plan() is None and not trace.enabled()
    f = flags.Flags(compute_dtype="bfloat16", obs_trace_enable=True,
                    obs_trace_sample=0.5, obs_trace_ring=16,
                    resilience_fault_spec="trainer.step:at=2")
    f.apply()
    assert dtypes.compute_dtype() == torch.bfloat16
    t = trace.get_tracer()
    assert (t.sample, t.capacity) == (0.5, 16)
    faults.hit("trainer.step")
    with pytest.raises(faults.InjectedFault):
        faults.hit("trainer.step")


# ------------------------------------------------- global prev_batch_state

def _net(M, cell, reverse=False):
    x = M.data_layer("x", size=(4 if cell == "lstmemory" else 3) * HID,
                     is_seq=True)
    return getattr(M, cell)(x, size=HID, reverse=reverse, name="rnn")


def _halves(full, lib, seq):
    mid = full.shape[1] // 2
    return [seq(lib.asarray(full[:, lo:hi]) if lib is jnp
                else torch.tensor(full[:, lo:hi]),
                lib.full((B,), hi - lo, dtype=lib.int32))
            for lo, hi in ((0, mid), (mid, full.shape[1]))]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= TOL * np.abs(want).max(), what


@pytest.mark.parametrize("cell", ["lstmemory", "grumemory"])
def test_global_prev_batch_state_carries_as_jax(cell, saved_flags):
    api.init(prev_batch_state=True)
    jax_api.init(prev_batch_state=True)
    width = (4 if cell == "lstmemory" else 3) * HID
    full = np.random.RandomState(2).randn(B, T, width).astype(np.float32)
    jax_reset_names()
    jtopo = JL.Topology(_net(JL, cell))
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), jtopo.init(jax.random.PRNGKey(0)))
    L.reset_names()
    topo = L.Topology(_net(L, cell))
    params = L.params_from_numpy(topo, tree, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jst, st, outs = {}, {}, []
    apply = jax.jit(lambda p, x, s: jtopo.apply(p, {"x": x}, mode="test",
                                                 state=s, return_state=True))
    for jh, th in zip(_halves(full, jnp, JaxSeq),
                      _halves(full, torch, SequenceBatch)):
        jo, jst = apply(jparams, jh, jst)
        o, st = topo.apply(params, {"x": th}, mode="test", state=st,
                           return_state=True)
        outs.append(value_data(o))
        _close(outs[-1].numpy(), jax_value(jo), f"{cell} half")
        assert set(st) == set(jst) == {"rnn/carry"}
        _close(st["rnn/carry"].numpy(), jst["rnn/carry"], f"{cell} carry")
    # the carried halves are one unbroken run
    ref = value_data(topo.apply(params, {"x": SequenceBatch(
        torch.tensor(full), torch.full((B,), T, dtype=torch.int32))},
        mode="test"))
    _close(torch.cat(outs, 1).numpy(), ref.numpy(), f"{cell} one run")


@pytest.mark.parametrize("cell", ["lstmemory", "grumemory"])
def test_global_prev_batch_state_skips_reversed_layers(cell, saved_flags):
    api.init(prev_batch_state=True)
    jax_api.init(prev_batch_state=True)
    L.reset_names()
    topo = L.Topology(_net(L, cell, reverse=True))      # no ConfigError
    params = topo.init(torch.Generator().manual_seed(0), device="cpu")
    width = (4 if cell == "lstmemory" else 3) * HID
    x = SequenceBatch(torch.randn(B, T, width),
                      torch.full((B,), T, dtype=torch.int32))
    _, st = topo.apply(params, {"x": x}, mode="test", state={},
                       return_state=True)
    jax_reset_names()
    jtopo = JL.Topology(_net(JL, cell, reverse=True))
    _, jst = jtopo.apply(jtopo.init(jax.random.PRNGKey(0)),
                         {"x": JaxSeq(jnp.asarray(x.data.numpy()),
                                      jnp.full((B,), T, jnp.int32))},
                         mode="test", state={}, return_state=True)
    assert st == {} and dict(jst) == {}
