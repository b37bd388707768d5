"""Public names of JAX modules whose port twin lacked them, each against
JAX's on the CPU: ``ops/attention.padding_mask``,
``ops/embedding.one_hot``, the ``optim`` namespace's ``schedules`` and
``averaging``, ``utils/error.ShapeError``, ``utils/stats.timer`` and
``print_all_stats``, ``utils/logging.log_context``, ``set_format`` and
``context_fields``, and ``utils``' exports (JAX's, less ``FLAGS``,
ROADMAP A5).  Masks and one-hot rows bit for bit; the log formats line
for line."""

import json
import logging

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu.optim as jax_optim
import paddle_tpu.utils as jax_utils
from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import embedding as jax_embedding
from paddle_tpu.utils import logging as jax_logging
import paddle_tpu_torch.optim as optim
import paddle_tpu_torch.utils as utils
from paddle_tpu_torch.ops import attention, embedding
from paddle_tpu_torch.utils import logging as plog
from paddle_tpu_torch.utils import stats


def test_padding_mask_matches_jax():
    rng = np.random.RandomState(0)
    q = (rng.rand(3, 5) > 0.3).astype(np.float32)
    k = (rng.rand(3, 7) > 0.3).astype(np.float32)
    got = attention.padding_mask(torch.tensor(q), torch.tensor(k))
    want = jax_attention.padding_mask(jnp.asarray(q), jnp.asarray(k))
    assert got.dtype == torch.bool and got.shape == (3, 1, 5, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_hot_matches_jax_out_of_range_ids_included():
    ids = np.asarray([[0, 3, -1], [4, 2, 5]], np.int32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = embedding.one_hot(torch.tensor(ids), 5, dtype=dtype)
        want = jax_embedding.one_hot(jnp.asarray(ids), 5, dtype=jdtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    assert not embedding.one_hot(torch.tensor(ids), 5)[0, 2].any()


def test_optim_exports_schedules_and_averaging_as_jax():
    assert optim.__all__ == jax_optim.__all__
    from paddle_tpu_torch.optim import averaging, schedules
    assert optim.schedules is schedules and optim.averaging is averaging


def test_utils_exports_are_jax_less_flags():
    assert utils.__all__ == [n for n in jax_utils.__all__ if n != "FLAGS"]
    assert issubclass(utils.ShapeError, utils.PaddleTpuError)
    assert not issubclass(utils.ShapeError, utils.ConfigError)


def test_timer_and_print_all_stats():
    reg = stats.StatRegistry()
    with stats.timer("step", reg) as stat:
        pass
    assert stat is reg.get("step") and stat.count == 1
    assert [n for n, _ in reg.items()] == ["step"]
    with stats.timer("twice"):
        pass
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    plog.logger.addHandler(handler)
    try:
        utils.print_all_stats()
    finally:
        plog.logger.removeHandler(handler)
    assert lines[0] == "======= StatSet =======" and any(
        "Stat(twice:" in line for line in lines)
    reg.reset_all()
    assert reg.get("step").count == 0


def _record(msg):
    return logging.LogRecord("x", logging.INFO, __file__, 1, msg, (), None)


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_log_context_and_formats_match_jax(fmt):
    rec = _record("hello")
    for mod in (plog, jax_logging):
        assert mod.context_fields() == {}
    with plog.log_context(trace_id="t1", request_id=7, empty=None), \
            jax_logging.log_context(trace_id="t1", request_id=7, empty=None):
        assert plog.context_fields() == jax_logging.context_fields() \
            == {"trace_id": "t1", "request_id": "7"}
        with plog.log_context(span="s"):
            assert plog.context_fields()["span"] == "s"
        got = plog._make_formatter(fmt).format(rec)
        want = jax_logging._make_formatter(fmt).format(rec)
    assert plog.context_fields() == {}
    if fmt == "json":
        got, want = json.loads(got), json.loads(want)
        assert got == want and got["trace_id"] == "t1"
    else:
        assert got == want and got.endswith(" request_id=7 trace_id=t1")


def test_set_format_switches_every_handler():
    log = plog.get_logger("paddle_tpu_torch.test_twin_names")
    try:
        plog.set_format("json")
        assert isinstance(log.handlers[0].formatter, plog._JsonFormatter)
        plog.set_format("text")
        assert isinstance(log.handlers[0].formatter, plog._TextFormatter)
    finally:
        plog._loggers.remove(log)
        log.handlers.clear()
