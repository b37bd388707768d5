"""The rest of the data path (A9·f): the device prefetcher
(``data/prefetch``) and ``SGD.train(prefetch=N)``, ``@provider`` with its
cache types, and the reference's proto data files
(``data/proto_format``), against the JAX package's on the CPU.

The prefetcher's contract has one test for each of
``tests/test_prefetch.py``'s cases but the mesh one (sharding is A12);
``train(prefetch=2)`` is bit for bit ``prefetch=0``; proto files written
by either package read in the other with equal bytes (the ``.gz`` ones'
decompressed bytes: gzip's header holds the write time).
"""

import gc
import gzip
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.data import proto_format as jproto
from paddle_tpu_torch.data import proto_format as tproto
from paddle_tpu_torch.data.prefetch import (ShardedPrefetcher,
                                            TransferWorker, device_placer)
from paddle_tpu_torch.scripts import bench
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.stats import global_stats
from paddle_tpu_torch.utils.tree import tree_leaves

CPU = device_placer(device="cpu")
# the modules (both packages' data/__init__ export the decorator under
# the module's name)
jprovider = importlib.import_module("paddle_tpu.data.provider")
tprovider = importlib.import_module("paddle_tpu_torch.data.provider")


def _arange_source(n, shape=(4,)):
    def source():
        for i in range(n):
            yield np.full(shape, i, np.float32)
    return source


# ------------------------------------------------------------ prefetcher

def test_ordering_and_values():
    out = list(ShardedPrefetcher(_arange_source(50), depth=3, place=CPU))
    assert len(out) == 50
    for i, a in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.full((4,), i))


def test_convert_runs_on_producer_thread():
    main = threading.get_ident()
    seen = []

    def convert(b):
        seen.append(threading.get_ident())
        return {"x": b * 2}

    out = list(ShardedPrefetcher(_arange_source(5), depth=2,
                                 convert=convert, place=CPU))
    assert seen and all(t != main for t in seen)
    np.testing.assert_array_equal(out[3]["x"].numpy(), np.full((4,), 6.0))


def test_bounded_depth():
    produced, consumed, max_ahead, depth = [], 0, 0, 2

    def place(b):
        produced.append(1)
        return b

    pf = ShardedPrefetcher(_arange_source(20), depth=depth, place=place)
    for _ in pf:
        time.sleep(0.01)
        consumed += 1
        max_ahead = max(max_ahead, len(produced) - consumed)
    assert consumed == 20 and max_ahead <= depth + 1, max_ahead


@pytest.mark.parametrize("where", ["source", "convert", "place"])
def test_exception_propagates_to_consumer(where):
    """A failure in the reader, the conversion or the placement surfaces
    in the consumer after the good batches, and ends the stream."""
    def source():
        for i in range(10):
            if where == "source" and i == 3:
                raise RuntimeError("boom in source")
            yield np.full((2,), i, np.float32)

    def fail_at_3(tag, then=lambda b: b):
        def fn(b):
            if int(np.asarray(b)[0]) == 3:
                raise RuntimeError(f"boom in {tag}")
            return then(b)
        return fn

    pf = ShardedPrefetcher(
        source, depth=2,
        convert=fail_at_3("convert") if where == "convert" else None,
        place=fail_at_3("place", CPU) if where == "place" else CPU)
    got = []
    with pytest.raises(RuntimeError, match=f"boom in {where}"):
        for b in pf:
            got.append(int(b[0]))
    assert got == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(pf)
    assert not pf._thread.is_alive()


def test_close_mid_stream_joins_producer():
    pf = ShardedPrefetcher(_arange_source(1000), depth=2, place=CPU)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()                              # idempotent
    with ShardedPrefetcher(_arange_source(1000), depth=2, place=CPU) as pf2:
        next(pf2)
    assert not pf2._thread.is_alive()


def test_start_false_autostarts_on_iteration():
    pf = ShardedPrefetcher(_arange_source(3), depth=2, place=CPU,
                           start=False)
    assert not pf._thread.is_alive()
    assert len(list(pf)) == 3


def test_abandoned_prefetcher_reclaimed_by_gc():
    def endless():
        i = 0
        while True:
            yield np.full((2,), i, np.float32)
            i += 1

    pf = ShardedPrefetcher(endless, depth=2, place=CPU)
    next(pf)
    thread = pf._thread
    del pf
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive()


def test_fresh_buffer_per_batch():
    """The donation discipline: every batch is a fresh tensor, never a
    pooled or re-delivered buffer, so a consumer that writes into (or
    frees) a feed cannot reach another batch's."""
    held = list(ShardedPrefetcher(_arange_source(10), depth=3, place=CPU))
    ptrs = {t.data_ptr() for t in held}
    assert len(ptrs) == 10
    acc = 0.0
    for x in held:
        acc += float(x.sum())
        x.zero_()                           # the consumer owns it
    assert acc == sum(4 * i for i in range(10))


def test_wait_accounting():
    def slow_source():
        for _ in range(3):
            time.sleep(0.05)
            yield np.zeros((2,), np.float32)

    pf = ShardedPrefetcher(slow_source, depth=2, place=CPU)
    list(pf)
    assert pf.batches == 3 and pf.wait_s > 0.01


def test_device_placer_and_its_mesh_refusal():
    feed = CPU({"x": np.ones((4, 2), np.float32)})
    assert isinstance(feed["x"], torch.Tensor)
    assert CPU.device == torch.device("cpu")
    with pytest.raises(ConfigError, match="A12"):
        device_placer(mesh=object())
    with pytest.raises(ValueError, match="depth"):
        ShardedPrefetcher(_arange_source(1), depth=0, place=CPU)


def test_transfer_worker_jobs_and_failures():
    with TransferWorker(depth=2) as worker:
        worker.submit("a", lambda: 1 + 1)
        worker.submit("b", lambda: 1 / 0)
        got = {}
        for _ in range(50):
            item = worker.poll(timeout=0.2)
            if item is not None:
                got[item[0]] = item[1]
            if len(got) == 2:
                break
    assert got["a"] == 2
    assert isinstance(got["b"].exc, ZeroDivisionError)
    assert not worker._thread.is_alive()


# ------------------------------------------------------ train(prefetch)

def test_train_prefetch_is_bit_for_bit_prefetch0():
    """bench_trainer_prefetch's MLP, shrunk: one pass at prefetch 2 and
    one at prefetch 0 from the same init give the same parameters bit
    for bit; each step's feed wait lands in h2d_wait."""
    b = bench.bench_trainer_prefetch(batch=8, dim=16, hidden=32,
                                     n_batches=6, host_ms=0.0, device="cpu")
    wait = global_stats.get("h2d_wait")
    wait.reset()
    sync = b.one_pass(0, b.trainer())
    assert wait.count == 6
    pre = b.one_pass(2, b.trainer())
    assert wait.count == 12
    for x, y in zip(tree_leaves(sync.parameters), tree_leaves(pre.parameters)):
        assert torch.equal(x, y)
    assert not torch.equal(tree_leaves(sync.parameters)[0],
                           tree_leaves(b.trainer().parameters)[0])
    with pytest.raises(ValueError, match="depth"):
        b.one_pass(-1)


def test_train_prefetch_surfaces_a_reader_error():
    b = bench.bench_trainer_prefetch(batch=4, dim=8, hidden=8, n_batches=2,
                                     host_ms=0.0, device="cpu")
    tr = b.trainer()
    from paddle_tpu_torch.data import dense_vector, integer_value

    def reader():
        yield [(np.zeros(8, np.float32), 0)] * 4
        raise OSError("disk gone")
    before = threading.active_count()
    with pytest.raises(OSError, match="disk gone"):
        tr.train(reader, feeding={"x": dense_vector(8),
                                  "lab": integer_value(2)},
                 log_period=0, prefetch=2)
    assert threading.active_count() <= before


# --------------------------------------------------------------- provider

def _provider(mod, calls):
    def hook(settings, file_list, **kw):
        settings.scale = kw.get("scale", 1)
        settings.slots = {"x": mod.dense_vector(2),
                          "y": mod.integer_value(3)}
        settings.input_types = None
        calls.append(("hook", tuple(file_list)))

    @mod.provider(init_hook=hook, cache=mod.CacheType.CACHE_PASS_IN_MEM)
    def gen(settings, filename):
        calls.append(("gen", filename))
        for i in range(3):
            yield {"x": [float(i) * settings.scale, float(len(filename))],
                   "y": i % 3}
    return gen


def test_provider_matches_jax():
    """init_hook (its slots as the reader's input_types), the keywords
    reaching it, CACHE_PASS_IN_MEM replaying the first pass without
    calling the generator again; plain attributes without a hook."""
    out = {}
    for mod in (jprovider, tprovider):
        calls = []
        reader = _provider(mod, calls)(["a", "bb"], scale=2)
        out[mod] = (list(reader()), list(reader()), calls,
                    reader.input_types)
    (j1, j2, jc, jt), (t1, t2, tc, tt) = out[jprovider], out[tprovider]
    assert t1 == j1 == t2 == j2 and len(t1) == 6
    assert tc == jc == [("hook", ("a", "bb")), ("gen", "a"), ("gen", "bb")]
    assert {k: (v.dim, v.seq_type.name, v.kind) for k, v in tt.items()} \
        == {k: (v.dim, v.seq_type.name, v.kind) for k, v in jt.items()}
    for mod in (jprovider, tprovider):
        types = {"x": mod.dense_vector(1)}

        @mod.provider(input_types=types)
        def plain(settings, filename):
            yield {"x": [settings.k]}
        reader = plain("f", k=5)
        assert list(reader()) == [{"x": [5]}]
        assert reader.input_types is types and plain.input_types is types
    assert [e.name for e in tprovider.CacheType] \
        == [e.name for e in jprovider.CacheType]


# ----------------------------------------------------------- proto files

SLOT_DEFS = [(tproto.VECTOR_DENSE, 3), (tproto.VECTOR_SPARSE_NON_VALUE, 10),
             (tproto.VECTOR_SPARSE_VALUE, 10), (tproto.INDEX, 5),
             (tproto.VAR_MDIM_DENSE, 6), (tproto.VAR_MDIM_INDEX, 20),
             (tproto.STRING, 0), (tproto.INDEX, 7)]


def _samples():
    rng = np.random.RandomState(3)
    out = []
    for i in range(5):
        out.append(((rng.randn(3).astype(np.float32),
                     sorted(rng.choice(10, 3, replace=False).tolist()),
                     ([1, 4], [0.5, -1.25]), int(rng.randint(5)),
                     rng.randn(2, 3).astype(np.float32),
                     rng.randint(0, 20, rng.randint(0, 4)).tolist(),
                     f"s{i} é", 6), i % 2 == 0))
    return out


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b))
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_proto_files_cross_both_ways(tmp_path, suffix):
    samples = _samples()
    paths = {}
    for name, mod in (("jax", jproto), ("port", tproto)):
        paths[name] = str(tmp_path / f"{name}.bin{suffix}")
        mod.write_proto_data(paths[name], SLOT_DEFS, samples)

    def raw(p):
        with (gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")) \
                as f:
            return f.read()
    assert raw(paths["jax"]) == raw(paths["port"])
    for writer in ("jax", "port"):
        jf = jproto.ProtoDataFile(paths[writer])
        tf = tproto.ProtoDataFile(paths[writer])
        assert tf.slot_defs == jf.slot_defs == SLOT_DEFS
        got, want = list(tf), list(jf)
        assert len(got) == len(want) == len(samples)
        for (gv, gb), (wv, wb) in zip(got, want):
            assert gb == wb
            _same(gv, wv)
        _same(tuple(tproto.reader_creator(paths[writer])()),
              tuple(v for v, _ in got))
    for (gv, gb), (sv, sb) in zip(tproto.ProtoDataFile(paths["port"]),
                                  samples):
        assert gb == sb and gv[6] == sv[6] and gv[3] == sv[3]


def test_proto_errors_match_jax(tmp_path):
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    trunc = tmp_path / "trunc.bin"
    tproto.write_proto_data(str(trunc), SLOT_DEFS, _samples())
    trunc.write_bytes(trunc.read_bytes()[:-3])
    for path, match in ((empty, "empty file"), (trunc, "truncated")):
        for mod, err in ((jproto, jproto.ConfigError),
                         (tproto, ConfigError)):
            with pytest.raises(err, match=match):
                list(mod.ProtoDataFile(str(path)))
