"""The port's tracer (``paddle_tpu_torch/obs/trace.py``) on the CPU:

- the unit cases of the JAX package's ``tests/test_obs_trace.py`` (the
  disabled path a strict no-op, nesting, async seams, the ring bound,
  deterministic sampling, unsampled spans, traceparent, the Chrome
  export, ``slowest``), run against the port; sampling verdicts equal
  JAX's on the same trace ids;
- on the same workload with tracing on, both packages record the same
  multiset of (span name, parent span's name, attribute keys): three
  ``SGD.train`` batches with ``prefetch=2`` (``data.h2d``,
  ``trainer.step``), a checkpoint write, and a tiny ``GenerationBatcher``
  behind ``make_server`` answering POSTs that carry a ``traceparent``
  header, chunked and on the prefill ladder (``server.request``,
  ``gen.queue_wait``, ``gen.prefill``, ``slot``); the server's
  ``X-Trace-Id``, body ``trace_id`` and ``GET /debug/traces``;
- with tracing off no span is recorded and the served tokens equal the
  traced run's bit for bit.
"""

import collections
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import jax
import torch

import paddle_tpu.layers as JL
import paddle_tpu.optim as jax_optim
from paddle_tpu.data import dense_vector as jax_dense
from paddle_tpu.data import integer_value as jax_int
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.obs import trace as jax_trace
from paddle_tpu.serving import make_server as jax_make_server
from paddle_tpu.serving.decode_engine import (
    DecodeEngine as JaxEngine, GenerationBatcher as JaxBatcher)
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.data import dense_vector, integer_value
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                      make_server)
from paddle_tpu_torch.trainer import SGD

VOCAB, HEADS, MAX_LEN, SLOTS = 64, 2, 48, 4


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    jax_trace.disable()
    yield
    trace.disable()
    jax_trace.disable()


# ------------------------------------------------------------------ units


def test_disabled_path_is_a_strict_noop():
    assert trace.span("x", a=1) is trace.NULL
    assert trace.start_span("y") is trace.NULL
    assert trace.instant("z") is trace.NULL
    assert trace.NULL.trace_id == "" and not trace.NULL.recording
    with trace.span("x"):
        assert trace.current() is None
    assert trace.NULL.set(a=1).event("e").end() is trace.NULL
    assert trace.snapshot() == []
    assert trace.slowest() == {"wall": [], "ttft": []}
    assert trace.debug_payload()["enabled"] is False
    assert trace.inject({}) == {}


def test_span_nesting_parents_and_context():
    trace.enable(sample=1.0, capacity=64, process="unit")
    with trace.span("root", route="/x") as r:
        assert trace.current() == (r.trace_id, r.span_id)
        with trace.span("mid") as m:
            with trace.span("leaf") as leaf:
                assert leaf.trace_id == r.trace_id
                assert leaf.parent_id == m.span_id
            assert m.parent_id == r.span_id
        assert trace.current() == (r.trace_id, r.span_id)
    assert trace.current() is None
    spans = {s["name"]: s for s in trace.snapshot()}
    assert set(spans) == {"root", "mid", "leaf"}
    assert spans["root"]["parent_id"] is None
    assert spans["root"]["attrs"]["root"] is True
    for s in spans.values():
        assert s["t_end"] >= s["t_start"]


def test_start_span_is_context_free_and_async_endable():
    trace.enable(sample=1.0, capacity=64, process="unit")
    with trace.span("req") as r:
        seam = trace.start_span("queue_wait")
        assert seam.parent_id == r.span_id
        assert trace.current() == (r.trace_id, r.span_id)
    done = []

    def other_thread():
        seam.event("picked")
        seam.end(batch_size=3)
        done.append(True)

    t = threading.Thread(target=other_thread)
    t.start()
    t.join(5)
    assert done
    s = next(s for s in trace.snapshot() if s["name"] == "queue_wait")
    assert s["attrs"]["batch_size"] == 3
    assert [e["name"] for e in s["events"]] == ["picked"]
    first_end = s["t_end"]
    seam.end()
    s2 = next(s for s in trace.snapshot() if s["name"] == "queue_wait")
    assert s2["t_end"] == first_end


def test_ring_bound_drops_oldest():
    trace.enable(sample=1.0, capacity=5, process="unit")
    for i in range(12):
        trace.start_span(f"s{i}").end()
    spans = trace.snapshot()
    assert [s["name"] for s in spans] == [f"s{i}" for i in range(7, 12)]
    assert trace.get_tracer().dropped_total == 7
    assert trace.get_tracer().started_total == 12


def test_sampling_is_deterministic_and_equals_jaxs():
    ids = [trace.new_trace_id() for _ in range(400)]
    a, b = trace.Tracer(sample=0.5), trace.Tracer(sample=0.5)
    verdicts = [a.sampled(i) for i in ids]
    assert verdicts == [b.sampled(i) for i in ids]
    # the same verdict the JAX package's tracer reaches on the same ids
    assert verdicts == [jax_trace.Tracer(sample=0.5).sampled(i)
                        for i in ids]
    assert 100 < sum(verdicts) < 300
    assert all(trace.Tracer(sample=1.0).sampled(i) for i in ids)
    assert not any(trace.Tracer(sample=0.0).sampled(i) for i in ids)


def test_unsampled_spans_keep_ids_but_never_record():
    trace.enable(sample=0.0, capacity=64, process="unit")
    with trace.span("root") as r:
        assert len(r.trace_id) == 32 and not r.recording
        with trace.span("child") as c:
            assert c.trace_id == r.trace_id
        assert r.trace_id in trace.inject({})["traceparent"]
    assert trace.snapshot() == []


def test_traceparent_round_trip_malformed_and_jax_compatible():
    trace.enable(sample=1.0, capacity=8, process="unit")
    with trace.span("root") as r:
        hdr = trace.inject({})["traceparent"]
    assert trace.extract(hdr) == (r.trace_id, r.span_id)
    assert jax_trace.extract(hdr) == (r.trace_id, r.span_id)
    for bad in (None, "", "junk", "00-short-id-01",
                "00-" + "x" * 32 + "-" + "cd" * 8 + "-01"):
        assert trace.extract(bad) is None


def test_chrome_trace_export_shape():
    trace.enable(sample=1.0, capacity=64, process="replica:1")
    with trace.span("server.request", route="/v1/generate") as r:
        sl = trace.start_span("slot", slot=2, mode="prefill")
        sl.event("first_token")
        sl.end(reason="length")
    obj = trace.chrome_trace()
    json.loads(json.dumps(obj))
    evs = obj["traceEvents"]
    procs = [e for e in evs if e["ph"] == "M"
             and e["name"] == "process_name"]
    assert [p["args"]["name"] for p in procs] == ["replica:1"]
    tracks = {e["args"]["name"] for e in evs if e["ph"] == "M"
              and e["name"] == "thread_name"}
    assert tracks == {"host", "slot 2"}
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(xs) == {"server.request", "slot"}
    assert xs["slot"]["tid"] == 102
    assert xs["slot"]["args"]["trace_id"] == r.trace_id
    assert [e["name"] for e in evs if e["ph"] == "i"] == ["first_token"]


def test_slowest_surfaces_worst_roots():
    trace.enable(sample=1.0, capacity=64, process="unit")
    for i, dt in enumerate((0.0, 0.03, 0.01)):
        with trace.span(f"r{i}", route="/x") as s:
            s.set(ttft_ms=dt * 500)
            time.sleep(dt)
        trace.start_span("noise").end()
    sl = trace.slowest(2)
    assert [r["name"] for r in sl["wall"]] == ["r1", "r2"]
    assert [r["name"] for r in sl["ttft"]] == ["r1", "r2"]


# ----------------------------------------------------- the same structure


def structure(spans):
    """The multiset of (name, parent span's name, attribute keys)."""
    names = {s["span_id"]: s["name"] for s in spans}
    return collections.Counter(
        (s["name"], names.get(s["parent_id"]), tuple(sorted(s["attrs"])))
        for s in spans)


def _train_graph(M):
    x = M.data_layer("tx", size=4)
    lab = M.data_layer("tlab", size=1)
    h = M.fc_layer(x, size=8, act="tanh")
    y = M.fc_layer(h, size=2, act="softmax")
    return M.classification_cost(y, lab)


def _reader():
    rng = np.random.RandomState(0)
    xs = rng.randn(24, 4).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(np.int64)
    for i in range(0, 24, 8):
        yield [(xs[j], int(ys[j])) for j in range(i, i + 8)]


def test_trainer_spans_match_jaxs(tmp_path):
    """Three SGD.train batches with prefetch=2 and a checkpoint write:
    the same span structure in both packages."""
    jax_trace.enable(sample=1.0, capacity=256, process="jax")
    jax_reset_names()
    jt = JaxSGD(_train_graph(JL), update_equation=jax_optim.Momentum(
        learning_rate=0.1, momentum=0.9), seed=0)
    jt.train(_reader, num_passes=1, log_period=0, prefetch=2,
             feeding={"tx": jax_dense(4), "tlab": jax_int(2)},
             save_dir=str(tmp_path / "jax"))
    want = structure(jax_trace.snapshot(include_active=False))
    trace.enable(sample=1.0, capacity=256, process="port")
    L.reset_names()
    tr = SGD(_train_graph(L), update_equation=optim.Momentum(
        learning_rate=0.1, momentum=0.9), device="cpu")
    tr.train(_reader, num_passes=1, log_period=0, prefetch=2,
             feeding={"tx": dense_vector(4), "tlab": integer_value(2)},
             save_dir=str(tmp_path / "port"))
    got = structure(trace.snapshot(include_active=False))
    assert got == want
    assert got[("trainer.step", None, ("batch", "h2d_wait_ms", "pass_id",
                                       "root"))] == 3
    assert got[("data.h2d", None, ("root",))] == 3
    assert got[("trainer.checkpoint.write", None,
                ("pass_id", "path", "root"))] == 1


def _jax_params():
    return jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                       d_model=32, num_heads=HEADS, dff=64, enc_layers=2,
                       dec_layers=0, max_len=MAX_LEN)


def _serve(batcher, server, prompts, headers):
    """POST each prompt (the second streamed) with its header; returns
    [(tokens, X-Trace-Id, body trace_id)] and the /debug/traces body."""
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.port}"
    out = []
    for i, (prompt, hdr) in enumerate(zip(prompts, headers)):
        body = {"prompt": prompt, "max_tokens": 5, "stream": i == 1}
        req = urllib.request.Request(
            f"{base}/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **hdr})
        with urllib.request.urlopen(req, timeout=120) as r:
            if body["stream"]:
                recs = [json.loads(line) for line in r]
                toks = [rec["token"] for rec in recs if "token" in rec]
                done = recs[-1]
            else:
                done = json.loads(r.read())
                toks = done["tokens"]
            out.append((toks, r.headers.get("X-Trace-Id"),
                        done.get("trace_id")))
    with urllib.request.urlopen(f"{base}/debug/traces", timeout=60) as r:
        debug = json.loads(r.read())
    server.shutdown()
    server.server_close()
    batcher.close()
    return out, debug


def _finished(tracer_mod, n):
    """The completed spans once the n request spans have ended (each
    ends just after its reply is written)."""
    deadline = time.time() + 30
    while time.time() < deadline:
        spans = tracer_mod.snapshot(include_active=False)
        if sum(s["name"] == "server.request" for s in spans) >= n:
            return spans
        time.sleep(0.01)
    raise AssertionError("request spans did not end")


@pytest.mark.parametrize("chunk", [4, 0], ids=["chunked", "ladder"])
def test_served_lm_spans_match_jaxs_and_off_is_bit_identical(chunk):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (5, 11)]
    parent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    headers = [{"traceparent": parent}, {}]
    tree = _jax_params()
    kw = dict(num_heads=HEADS, num_slots=SLOTS, max_len=MAX_LEN,
              prefill_buckets=(8, 16), prefill_chunk=chunk)

    jax_trace.enable(sample=1.0, capacity=256, process="jax")
    jgen = JaxBatcher(JaxEngine(tree, **kw))
    jout, _ = _serve(jgen, jax_make_server(None, port=0, gen_batcher=jgen),
                     prompts, headers)
    want = structure(_finished(jax_trace, 2))

    params = transformer.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), "cpu")
    runs = {}
    for on in (True, False):
        if on:
            trace.enable(sample=1.0, capacity=256, process="port")
        else:
            trace.disable()
        gen = GenerationBatcher(DecodeEngine(params, device="cpu", **kw))
        runs[on] = _serve(gen, make_server(gen), prompts, headers)
        if on:
            spans = _finished(trace, 2)
    (out, debug), (off, off_debug) = runs[True], runs[False]
    assert structure(spans) == want
    names = collections.Counter(s["name"] for s in spans)
    assert names["server.request"] == 2 and names["slot"] == 2
    assert names["gen.queue_wait"] == 2
    assert names["gen.prefill"] == (2 if chunk == 0 else 0)
    # the first request continued the incoming trace; ids echoed
    root = next(s for s in spans if s["name"] == "server.request"
                and s["trace_id"] == "ab" * 16)
    assert root["parent_id"] == "cd" * 8
    for toks, hdr_id, body_id in out:
        assert hdr_id and hdr_id == body_id
    assert out[0][1] == "ab" * 16
    assert debug["enabled"] and debug["process"] == "port"
    assert {s["name"] for s in debug["spans"]} >= {"server.request", "slot"}
    # tracing off: nothing recorded, the same tokens bit for bit, no ids
    assert trace.snapshot() == [] and not off_debug["enabled"]
    assert [o[0] for o in off] == [o[0] for o in out]
    assert all(o[1] is None and o[2] is None for o in off)
    # the JAX server answered both requests in full
    assert [len(o[0]) for o in jout] == [5, 5]
