"""The port's ``/v1/infer`` plane (``serving/engine.py`` InferenceEngine,
``serving/batcher.py`` Batcher, ``serving/server.py``) against the JAX
package's, on the CPU: counterparts of JAX's ``tests/test_serving.py``
engine, batcher, HTTP and metrics cases and of the readiness and
Retry-After cases of ``tests/test_resilience.py``.

The models are JAX's test MLP (8 -> fc 16 tanh -> fc 4 softmax) and its
sequence classifier (embedding 8 -> max pool -> fc 2 softmax), with
JAX's parameters carried across by ``params_from_numpy``.  Bucket
padding and chunking leave every row bit for bit the port's direct
forward at the same bucket (the pad rows replicate a real one, and the
CPU's GEMM gives a row the same result in the same batch shape); the
port's outputs equal JAX's ``InferenceEngine`` within TOL of each
output's largest entry (float32, sums in different orders).  JAX's
export-artifact and ``lower()`` cases become the refusals that name
ROADMAP A11 and A13.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers import api as JL
from paddle_tpu.layers.graph import Topology as JaxTopology
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.serving import (BreakerOpenError as JaxBreakerOpen,
                                InferenceEngine as JaxInferenceEngine,
                                OverloadedError as JaxOverloaded,
                                ServingMetrics as JaxMetrics,
                                ShutdownError as JaxShutdown)
from paddle_tpu.serving import server as jax_server
from paddle_tpu_torch import layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.graph import Topology
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.resilience import Supervisor, faults
from paddle_tpu_torch.serving import (BatchExecutionError, Batcher,
                                      BreakerOpenError, DecodeEngine,
                                      DeadlineExceededError,
                                      GenerationBatcher, InferenceEngine,
                                      InvalidRequestError, OverloadedError,
                                      ServingMetrics, ShutdownError,
                                      make_server)
from paddle_tpu_torch.serving import server
from paddle_tpu_torch.serving.engine import ShapeDtype, _pad_rows
from paddle_tpu_torch.trainer.trainer import Inferencer
from paddle_tpu_torch.utils.error import ConfigError

TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear()


def _mlp(dim=8, hidden=16, classes=4):
    """(JAX output layer, JAX params, port output layer, port params)."""
    jax_reset_names()
    x = JL.data_layer("x", size=dim)
    h = JL.fc_layer(input=x, size=hidden, act="tanh")
    jout = JL.fc_layer(input=h, size=classes, act="softmax")
    tree = JaxTopology([jout]).init(jax.random.PRNGKey(0))
    L.reset_names()
    x = L.data_layer("x", size=dim)
    h = L.fc_layer(input=x, size=hidden, act="tanh")
    out = L.fc_layer(input=h, size=classes, act="softmax")
    params = L.params_from_numpy(Topology([out]), jax.tree_util.tree_map(
        np.asarray, tree), "cpu")
    return jout, tree, out, params


@pytest.fixture(scope="module")
def mlp():
    return _mlp()


def _engine(mlp, buckets=(4, 16), warm=True, **kw):
    _jout, _tree, out, params = mlp
    spec = {"x": ShapeDtype((1, 8), np.dtype(np.float32))}
    return InferenceEngine.from_topology(out, params, spec, buckets=buckets,
                                         warm=warm, device="cpu", **kw)


def _direct(mlp, xb, bucket):
    """The port's forward at ``bucket`` rows (``xb`` padded as the
    engine pads), real rows sliced back."""
    _jout, _tree, out, params = mlp
    padded = _pad_rows({"x": xb}, bucket)["x"]
    with torch.no_grad():
        got = Topology([out]).apply(params, {"x": torch.from_numpy(padded)},
                                    mode="test")
    return got.numpy()[:len(xb)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


# ---------------------------------------------------------------- engine

def test_engine_pads_to_bucket_and_slices_back(mlp):
    eng = _engine(mlp)
    jout, tree = mlp[:2]
    jeng = JaxInferenceEngine.from_topology(
        jout, tree, {"x": jax.ShapeDtypeStruct((1, 8), np.float32)},
        buckets=(4, 16), warm=False)
    rng = np.random.RandomState(0)
    for b in (1, 3, 4, 5, 16):
        xb = rng.randn(b, 8).astype(np.float32)
        got = eng.infer({"x": xb})
        assert got.shape == (b, 4)
        np.testing.assert_array_equal(got, _direct(mlp, xb,
                                                   eng.bucket_for(b)))
        _close(got, np.asarray(jeng.infer({"x": xb})))
    snap = eng.metrics.snapshot()
    assert snap["batches_total"] == 5 and snap["batch_rows_total"] == 29
    assert snap["batch_slots_total"] == 4 + 4 + 4 + 16 + 16


def test_engine_chunks_batches_beyond_ladder_top(mlp):
    eng = _engine(mlp)
    xb = np.random.RandomState(1).randn(37, 8).astype(np.float32)
    got = eng.infer({"x": xb})
    assert got.shape == (37, 4)
    want = np.concatenate([_direct(mlp, xb[:16], 16),
                           _direct(mlp, xb[16:32], 16),
                           _direct(mlp, xb[32:], 16)])
    np.testing.assert_array_equal(got, want)


def test_engine_trace_count_stable_after_warmup(mlp):
    eng = _engine(mlp, warm=True)
    assert eng.trace_count == 2 and eng.ready
    rng = np.random.RandomState(2)
    for b in (1, 2, 4, 9, 16, 33):
        eng.infer({"x": rng.randn(b, 8).astype(np.float32)})
    assert eng.trace_count == 2


def test_engine_lazy_compile_on_first_use(mlp):
    eng = _engine(mlp, warm=False)
    assert eng.trace_count == 0 and not eng.ready
    eng.infer({"x": np.zeros((3, 8), np.float32)})
    assert eng.trace_count == 1
    eng.infer({"x": np.zeros((2, 8), np.float32)})
    assert eng.trace_count == 1
    assert eng.warmup() == 1 and eng.ready and eng.trace_count == 2


def test_engine_validates_feeds(mlp):
    eng = _engine(mlp, warm=False)
    for feed, kw in (({"x": np.zeros((2, 5), np.float32)}, {}),
                     ({"x": np.zeros((2, 8), np.int32)}, {}),
                     ({"y": np.zeros((2, 8), np.float32)}, {}),
                     ({"x": np.zeros((8,), np.float32)}, {}),
                     ({"x": np.zeros((3, 8), np.float32)},
                      {"batch": False})):
        with pytest.raises(InvalidRequestError):
            eng.validate(feed, **kw)
    assert eng.validate({"x": np.zeros((8,), np.float32)}, batch=False) == 1
    assert eng.validate({"x": torch.zeros(5, 8)}) == 5
    assert eng.bucket_spec(4) == {"x": ShapeDtype((4, 8),
                                                  np.dtype(np.float32))}


@pytest.mark.parametrize("stage", ["lower", "from_artifact",
                                   "from_artifacts"])
def test_jax_only_stages_refuse_naming_roadmap(mlp, stage):
    if stage == "lower":
        with pytest.raises(ConfigError, match="A13"):
            _engine(mlp, warm=False).lower(16)
    else:
        with pytest.raises(ConfigError, match="A11"):
            getattr(InferenceEngine, stage)("model.b*.shlo")


def test_sequence_feeds_across_padded_lengths_match_jax():
    """JAX's v2 sequence case through ``from_inferencer``: one engine per
    padded length, SequenceBatch feeds padded and sliced by rows."""
    jax_reset_names()
    ids = JL.data_layer("ids", size=50)
    emb = JL.embedding_layer(input=ids, size=8)
    jout = JL.fc_layer(input=JL.pooling_layer(input=emb, pooling_type=None),
                       size=2, act="softmax")
    tree = JaxTopology([jout]).init(jax.random.PRNGKey(0))
    L.reset_names()
    ids = L.data_layer("ids", size=50, is_seq=True)
    emb = L.embedding_layer(input=ids, size=8)
    out = L.fc_layer(input=L.pooling_layer(input=emb, pooling_type=None),
                     size=2, act="softmax")
    params = L.params_from_numpy(Topology([out]), jax.tree_util.tree_map(
        np.asarray, tree), "cpu")
    inf = Inferencer(out, params, device="cpu")
    rng = np.random.RandomState(8)
    for b, t in ((3, 7), (5, 12), (2, 7)):
        data = rng.randint(0, 50, (b, t)).astype(np.int32)
        lengths = rng.randint(1, t + 1, (b,)).astype(np.int32)
        spec = {"ids": SequenceBatch(np.zeros((1, t), np.int32),
                                     np.zeros((1,), np.int32))}
        eng = InferenceEngine.from_inferencer(inf, spec, buckets=(4, 8))
        got = eng.infer({"ids": SequenceBatch(data, lengths)})
        assert got.shape == (b, 2)
        jspec = {"ids": JaxSeq(jax.ShapeDtypeStruct((1, t), np.int32),
                               jax.ShapeDtypeStruct((1,), np.int32))}
        jeng = JaxInferenceEngine.from_topology(jout, tree, jspec,
                                                buckets=(4, 8), warm=False)
        want = np.asarray(jeng.infer({"ids": JaxSeq(jnp.asarray(data),
                                                    jnp.asarray(lengths))}))
        _close(got, want)
        with pytest.raises(InvalidRequestError):
            eng.validate({"ids": SequenceBatch(data[:, :t - 1], lengths)})


# ---------------------------------------------------------------- batcher

def test_concurrent_clients_bit_identical_and_batched(mlp):
    eng = _engine(mlp)
    xb = np.random.RandomState(3).randn(16, 8).astype(np.float32)
    bat = Batcher(eng, max_delay_ms=100.0, queue_size=64)
    results = [None] * 16

    def client(i):
        results[i] = bat.submit({"x": xb[i]}).result(30)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bat.close()
    # every row is the direct forward of that row at its batch's bucket
    for i in range(16):
        assert any(np.array_equal(results[i], _direct(mlp, xb[i:i + 1], b)[0])
                   for b in (4, 16)), i
    snap = eng.metrics.snapshot()
    assert snap["responses_total"] == 16 and snap["errors_total"] == 0
    assert snap["mean_occupancy"] > 1.0, snap


def _stalled_engine(mlp, stall_s=0.15):
    eng = _engine(mlp)
    orig = eng.infer

    def slow(feed):
        time.sleep(stall_s)
        return orig(feed)
    eng.infer = slow
    return eng


def test_fault_injection_all_paths_and_engine_stays_healthy(mlp):
    eng = _stalled_engine(mlp, stall_s=0.2)
    row = {"x": np.zeros((8,), np.float32)}
    bat = Batcher(eng, max_delay_ms=0.0, queue_size=3)
    with pytest.raises(InvalidRequestError):
        bat.submit({"x": np.zeros((5,), np.float32)})
    with pytest.raises(InvalidRequestError):
        bat.submit({"x": np.zeros((8,), np.int64)})
    first = bat.submit(row)
    time.sleep(0.05)
    q1, q2 = bat.submit(row), bat.submit(row)
    dead = bat.submit(row, deadline_ms=10)
    with pytest.raises(OverloadedError):
        bat.submit(row)
    with pytest.raises(DeadlineExceededError):
        dead.result(30)
    for f in (first, q1, q2):
        assert f.result(30).shape == (4,)
    snap = bat.metrics.snapshot()
    assert (snap["rejected"]["invalid"], snap["rejected"]["overload"],
            snap["rejected"]["deadline"]) == (2, 1, 1)

    def boom(feed):
        raise RuntimeError("injected batch failure")
    healthy, eng.infer = eng.infer, boom
    with pytest.raises(BatchExecutionError):
        bat.submit(row).result(30)
    eng.infer = healthy
    assert bat.submit(row).result(30).shape == (4,)
    assert bat.metrics.snapshot()["errors_total"] == 1
    bat.close()


def test_engine_execute_fault_isolated_and_keeps_serving(mlp):
    eng = _engine(mlp)
    bat = Batcher(eng, max_delay_ms=0.0, queue_size=64)
    row = {"x": np.zeros((8,), np.float32)}
    faults.install_spec("serving.engine.execute:at=1")
    with pytest.raises(BatchExecutionError):
        bat.submit(row).result(30)
    faults.clear()
    assert bat.submit(row).result(30).shape == (4,)
    assert eng.metrics.snapshot()["errors_total"] == 1
    bat.close()


def test_drain_on_shutdown(mlp):
    eng = _stalled_engine(mlp, stall_s=0.1)
    row = {"x": np.zeros((8,), np.float32)}
    bat = Batcher(eng, max_delay_ms=0.0, queue_size=64)
    futs = [bat.submit(row) for _ in range(6)]
    t = threading.Thread(target=bat.close, kwargs={"drain": True})
    t.start()
    time.sleep(0.02)
    with pytest.raises(ShutdownError):
        bat.submit(row)
    t.join(30)
    for f in futs:
        assert f.result(0).shape == (4,)
    assert bat.metrics.snapshot()["rejected"]["shutdown"] == 1


def test_client_cancel_does_not_kill_the_worker(mlp):
    eng = _stalled_engine(mlp, stall_s=0.1)
    row = {"x": np.zeros((8,), np.float32)}
    bat = Batcher(eng, max_delay_ms=0.0, queue_size=64)
    bat.submit(row)
    time.sleep(0.02)
    victim = bat.submit(row)
    assert victim.cancel()
    assert bat.submit(row).result(30).shape == (4,)
    assert victim.cancelled()
    bat.close()


def test_zero_queue_size_rejected(mlp):
    with pytest.raises(ValueError):
        Batcher(_engine(mlp, warm=False), queue_size=0)


def test_close_without_drain_fails_queued_requests(mlp):
    eng = _stalled_engine(mlp, stall_s=0.2)
    row = {"x": np.zeros((8,), np.float32)}
    bat = Batcher(eng, max_delay_ms=0.0, queue_size=64)
    bat.submit(row)
    time.sleep(0.05)
    queued = [bat.submit(row) for _ in range(3)]
    bat.close(drain=False)
    failed = 0
    for f in queued:
        with pytest.raises(ShutdownError):
            f.result(30)
        failed += 1
    assert failed == 3


# ---------------------------------------------------------------- HTTP

def _start(mlp, eng=None, **batcher_kw):
    bat = Batcher(eng or _engine(mlp),
                  **{"max_delay_ms": 50.0, "queue_size": 64, **batcher_kw})
    httpd = make_server(bat, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, bat


def _post(port, payload, path="/v1/infer", raw=None):
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_http_concurrent_clients_match_direct_forward(mlp):
    httpd, bat = _start(mlp)
    try:
        xb = np.random.RandomState(7).randn(8, 8).astype(np.float32)
        results = [None] * 8

        def client(i):
            status, resp = _post(httpd.port,
                                 {"feed": {"x": xb[i].tolist()}})
            assert status == 200
            results[i] = np.asarray(resp["outputs"], np.float32)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for i in range(8):
            # JSON round-trips float32 exactly
            assert any(np.array_equal(results[i],
                                      _direct(mlp, xb[i:i + 1], b)[0])
                       for b in (4, 16)), i
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.port}/metrics", timeout=30) as r:
            text = r.read().decode()
        name = bat.metrics.name
        assert f"{name}_requests_total 8" in text
        assert f'{name}_latency_seconds{{quantile="0.99"}}' in text
        assert f"{name}_batches_total" in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.port}/healthz", timeout=30) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["buckets"] == [4, 16]
    finally:
        httpd.shutdown()
        bat.close()


def test_http_fault_paths(mlp):
    httpd, bat = _start(mlp)
    try:
        def expect(code, payload=None, raw=None, path="/v1/infer"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(httpd.port, payload, path=path, raw=raw)
            assert ei.value.code == code
            return json.loads(ei.value.read())

        assert "error" in expect(400, raw=b"{not json")
        assert "error" in expect(400, {"nofeed": 1})
        assert "error" in expect(400, {"feed": {"x": [1.0] * 5}})
        assert "error" in expect(400, {"feed": {"x": [1.0] * 8,
                                                "bogus": [1]}})
        assert "error" in expect(400, {"feed": {"x": [1.0] * 8},
                                       "deadline_ms": -5})
        assert "error" in expect(404, {"feed": {}}, path="/v1/nope")
        assert "error" in expect(404, {"prompt": [1]}, path="/v1/generate")
        status, resp = _post(httpd.port, {"feed": {"x": [0.5] * 8}})
        assert status == 200 and len(resp["outputs"]) == 4
    finally:
        httpd.shutdown()
        bat.close()


def test_http_readyz_warming_and_overload_retry_after(mlp):
    eng = _engine(mlp, warm=False)
    httpd, bat = _start(mlp, eng, max_delay_ms=0.0, queue_size=2)
    base = f"http://127.0.0.1:{httpd.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/readyz", timeout=30)
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"] == "1"
        assert json.loads(ei.value.read())["reasons"] == ["warming"]
        eng.warmup()
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ready"
        orig = eng.infer

        def slow(feed):
            time.sleep(0.4)
            return orig(feed)
        eng.infer = slow
        row = {"x": np.zeros((8,), np.float32)}
        bat.submit(row)
        time.sleep(0.05)
        bat.submit(row)
        bat.submit(row)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(httpd.port, {"feed": {"x": [0.0] * 8}})
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        eng.infer = orig
    finally:
        httpd.shutdown()
        bat.close()


def test_http_readyz_retry_after_and_liveness():
    """The generation plane behind a supervised batcher: /healthz stays
    200 through breaker-open and drain, /readyz answers 503 with
    breaker_open (Retry-After the cooldown left) then draining
    (Retry-After the drain deadline), and a generate request sheds 503 +
    Retry-After while the breaker is open."""
    params = transformer.init_lm(torch.Generator().manual_seed(0), 64, 32,
                                 2, 64, 2, 48, device="cpu")
    eng = DecodeEngine(params, num_heads=2, num_slots=2, max_len=48,
                       prefill_chunk=4, device="cpu")
    sup = Supervisor(breaker_threshold=1, breaker_cooldown_s=30.0)
    gen = GenerationBatcher(eng, supervisor=sup)
    httpd = make_server(None, port=0, gen_batcher=gen)
    httpd.drain_timeout_s = 7
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.port}"
    try:
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ready"
        sup.breaker.record_failure()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/readyz", timeout=30)
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) in (29, 30)
        assert json.loads(ei.value.read())["reasons"] == ["breaker_open"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["draining"] is False
        req = urllib.request.Request(
            f"{base}/v1/generate",
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) in (30, 31)
        sup.breaker.record_success()
        gen.close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/readyz", timeout=30)
        assert ei.value.headers["Retry-After"] == "7"
        assert json.loads(ei.value.read())["reasons"] == ["draining"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["draining"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503 and ei.value.headers["Retry-After"] == "7"
    finally:
        httpd.shutdown()
        gen.close()


@pytest.mark.parametrize("case", ["breaker", "overload", "shutdown",
                                  "other"])
def test_retry_after_for_equals_jax(case):
    ms = {}
    for name, metrics_cls in (("port", ServingMetrics),
                              ("jax", JaxMetrics)):
        m = metrics_cls(name="t")
        for s in (0.2, 0.3, 0.5):
            m.observe_batch(4, 4, s)
        m.queue_depth_fns.append(lambda: 9)
        ms[name] = m
    errs = {"breaker": (BreakerOpenError("x", retry_after_s=2.2),
                        JaxBreakerOpen("x", retry_after_s=2.2)),
            "overload": (OverloadedError("x"), JaxOverloaded("x")),
            "shutdown": (ShutdownError("x"), JaxShutdown("x")),
            "other": (RuntimeError("x"), RuntimeError("x"))}[case]
    got = server._retry_after_for(errs[0], ms["port"], drain_timeout_s=12.5)
    want = jax_server._retry_after_for(errs[1], ms["jax"],
                                       drain_timeout_s=12.5)
    assert got == want


# ---------------------------------------------------------------- metrics

def test_metrics_prometheus_render_and_waste():
    m = ServingMetrics(name="t")
    m.accepted()
    m.observe_batch(n_real=3, bucket=4, seconds=0.002)
    m.observe_response(0.010)
    m.reject("overload")
    m.reject("breaker")
    assert m.mean_occupancy == 3.0
    assert m.padding_waste == pytest.approx(0.25)
    text = m.render_prometheus()
    for line in ("t_requests_total 1", 't_rejected_total{reason="overload"} 1',
                 't_rejected_total{reason="breaker"} 1',
                 't_latency_seconds{quantile="0.50"} 0.010000',
                 "t_batch_occupancy_mean 3.000000",
                 "t_padding_waste_ratio 0.250000", "t_batches_total 1",
                 't_slot_evictions_total{reason="recovered"} 0',
                 "t_breaker_state 0", "t_watchdog_trips_total 0"):
        assert line in text, line
    assert m.snapshot()["latency_ms"]["p99"] == pytest.approx(10.0)


# ---------------------------------------------------------------- CLI

def test_drain_deadline_and_second_sigterm_unit():
    """The SIGTERM handler's forced exits, without signals: a wedged
    drain exits 3 at the deadline, a second signal 130 at once, and a
    drain that completes in time never exits."""
    class FakeHttpd:
        def shutdown(self):
            pass

    exits, state = [], {}
    handler = server._make_drain_handler(FakeHttpd(), state, 0.2,
                                         exits.append)
    handler(15, None)
    assert exits == []
    handler(15, None)
    assert exits == [130]
    time.sleep(0.3)
    assert exits == [130, 3]
    exits2, state2 = [], {}
    handler2 = server._make_drain_handler(FakeHttpd(), state2, 0.2,
                                          exits2.append)
    handler2(15, None)
    state2["drained"] = True
    time.sleep(0.3)
    assert exits2 == []


def test_cli_flags_supervised_generation_and_demo_plane():
    """The CLI's new flags take JAX's FLAGS defaults; the generation plane
    it builds is supervised (a watchdog only with --step-deadline-ms) and
    the --demo MLP shares its /metrics on one server."""
    from paddle_tpu_torch.utils.flags import FLAGS
    args = server.parse_args([])
    assert (args.kv_host_bytes, args.step_deadline_ms, args.deadline_ms,
            args.breaker_threshold, args.breaker_cooldown_s,
            args.drain_timeout_s, args.demo) == (
        FLAGS.serving_kv_host_bytes, None, None,
        FLAGS.resilience_breaker_threshold,
        FLAGS.resilience_breaker_cooldown_s, FLAGS.serving_drain_timeout_s,
        False)
    args = server.parse_args([
        "--device", "cpu", "--slots", "2", "--max-len", "48",
        "--prefill-chunk", "4", "--kv-layout", "paged", "--kv-block-size",
        "8", "--kv-host-bytes", str(1 << 20), "--step-deadline-ms", "5000",
        "--breaker-threshold", "2", "--breaker-cooldown-s", "0.5",
        "--deadline-ms", "30000", "--demo", "--buckets", "1,4"])
    gen = server.batcher_from_args(args, vocab=64, d_model=32, num_heads=2,
                                   dff=64, layers=2)
    sup = gen.supervisor
    assert sup.step_deadline_s == 5.0 and sup.breaker.threshold == 2
    assert gen.engine.host_tier.cap_bytes == 1 << 20
    assert gen.default_deadline_s == 30.0
    bat = server.demo_batcher((1, 4), device="cpu", metrics=gen.metrics)
    httpd = make_server(bat, port=0, gen_batcher=gen)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, resp = _post(httpd.port,
                             {"feed": {"serving_demo_x": [0.5] * 16}})
        assert status == 200 and len(resp["outputs"]) == 4
        status, resp = _post(httpd.port, {"prompt": [3, 4, 5],
                                           "max_tokens": 3},
                             path="/v1/generate")
        assert status == 200 and len(resp["tokens"]) == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.port}/metrics", timeout=30) as r:
            text = r.read().decode()
        name = gen.metrics.name
        assert f"{name}_batches_total 1" in text
        assert f"{name}_gen_tokens_total 3" in text
    finally:
        httpd.shutdown()
        bat.close()
        gen.close()
