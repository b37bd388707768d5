"""The router on the port (``serving/router.py``): its policies over
scripted stub replicas (readiness gating, least-loaded dispatch, outlier
ejection with half-open readmission on an injected clock, the
``router.dispatch`` fault point, hedged ``/v1/infer``, overload
shedding and the brownout rungs), and over in-process port replicas
that carry JAX's tiny trunk (``transformer.params_from_numpy``): the
mid-stream failover (bit for bit the stream without the fault, and
JAX's ``lm_generate`` up to the first top-1/top-2 margin below MARGIN),
client-disconnect abandon, and the prefill/decode handoff with its
counters and both recompute fallbacks (below the analytic crossover, and
against a dead source).  ``RouterMetrics`` / ``render_prometheus`` are
held equal to JAX's after the same events, ``serving.__all__`` covers
JAX's, and ``python -m paddle_tpu_torch.serving.router`` serves one CPU
replica.  Everything runs on the CPU.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import paddle_tpu.serving as jax_serving
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.serving import router as jax_router
from paddle_tpu_torch.models import transformer as torch_tf
import paddle_tpu_torch.serving as torch_serving
from paddle_tpu_torch.resilience import FaultPlan, faults
from paddle_tpu_torch.serving import (AIMDLimiter, Autoscaler,
                                      BrownoutLadder, DecodeEngine,
                                      GenerationBatcher, OverloadController,
                                      Router, ServingMetrics, make_server)
from paddle_tpu_torch.serving import router as torch_router
from paddle_tpu_torch.serving.router import _stream_generate
from test_autoscaler import _Stub, _post_raw
from test_fleet import _StubReplica, _post, _stream, _wait

VOCAB, HEADS, MAX_LEN, SLOTS = 64, 2, 64, 4
BS = 8                      # the paged pair's block size
MARGIN = 2e-3
N_TOK = 20                  # tokens a handed-off stream runs
FAILOVER_PROMPT = np.random.RandomState(7).randint(1, VOCAB, 6).tolist()
HANDOFF_LENGTHS = [32, 40, 16, 32]
_rng = np.random.RandomState(7)
HANDOFF_PROMPTS = [_rng.randint(1, VOCAB, n).tolist()
                   for n in HANDOFF_LENGTHS + [32]]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear()


@pytest.fixture(scope="module")
def jparams():
    return jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB, trg_vocab=1,
                       d_model=32, num_heads=HEADS, dff=64, enc_layers=2,
                       dec_layers=0, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def jax_ref(jparams):
    """JAX's lm_generate over every prompt the streams below serve, in
    one ragged batch (one trace): row 0 the failover prompt, then the
    handoff prompts."""
    return _jax_reference(jparams, [FAILOVER_PROMPT] + HANDOFF_PROMPTS,
                          N_TOK)


@pytest.fixture(scope="module")
def tparams(jparams):
    return torch_tf.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _engine(tparams, name, **kw):
    return DecodeEngine(tparams, num_heads=HEADS, num_slots=SLOTS,
                        max_len=MAX_LEN, name=name, device="cpu", **kw)


def _serve(engine, role=None):
    gen = GenerationBatcher(engine)
    if role is not None:
        gen.metrics.set_serving_role(role)
    httpd = make_server(None, port=0, gen_batcher=gen)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return gen, httpd, f"http://127.0.0.1:{httpd.port}"


def _stop(gen, httpd):
    httpd.shutdown()
    httpd.server_close()
    gen.close()


@pytest.fixture(scope="module")
def replica(tparams):
    """One real in-process port replica (chunked slab engine)."""
    gen, httpd, url = _serve(_engine(tparams, "router_lm"))
    yield gen, httpd, url
    _stop(gen, httpd)


def _jax_reference(jparams, prompts, n_tokens):
    """JAX's lm_generate over the prompts (one ragged batch) and the
    top-1/top-2 logit margin at every position of its output."""
    lengths = np.asarray([len(p) for p in prompts])
    padded = np.zeros((len(prompts), lengths.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    ids = np.asarray(jax_tf.lm_generate(jparams, padded,
                                        int(lengths.max()) + n_tokens,
                                        HEADS, prompt_lengths=lengths))
    hidden, _ = jax_tf.lm_prefill(jparams, jnp.asarray(ids), ids.shape[1],
                                  HEADS)
    top2 = np.sort(np.asarray(jax_tf._lm_project(jparams, hidden)), -1)
    return ids, lengths, top2[..., -1] - top2[..., -2]


def _agree_with_jax(streams, ref, rows):
    """Each stream equals JAX's continuation (reference row ``rows[k]``)
    up to the first position whose reference margin is below MARGIN;
    returns tokens compared."""
    ids, lengths, margins = ref
    n = 0
    for i, toks in zip(rows, streams):
        for t, tok in enumerate(toks):
            if margins[i, lengths[i] - 1 + t] < MARGIN:
                break
            assert tok == int(ids[i, lengths[i] + t]), (i, t, toks)
            n += 1
    return n


def _all_ready(router, n):
    return len([s for s in router.replica_states().values()
                if s["ready"]]) == n


# ----------------------------------------------------- stub-replica policy


def test_router_readiness_gating_and_least_loaded():
    """An unready replica is never dispatched to; among ready ones the
    smaller polled queue depth wins.  The assertions wait until every
    ready replica has been probed (``Router.ready`` turns true once any
    one is)."""
    a = _StubReplica(ready=False)
    b = _StubReplica(depth=5)
    c = _StubReplica(depth=0)
    router = Router(replicas=[a.url, b.url, c.url], poll_interval_s=0.05,
                    hedge_ms=0)
    httpd = router.start(port=0)
    try:
        assert _wait(lambda: _all_ready(router, 2), 10)
        assert _wait(lambda: router.replica_states()["r1"]["queue_depth"]
                     == 5, 10)
        for _ in range(4):
            st, out = _post(httpd.port, "/v1/infer", {"feed": {}})
            assert st == 200 and "outputs" in out
        assert (a.infer_hits, b.infer_hits, c.infer_hits) == (0, 0, 4)
        a.ready = True
        assert _wait(lambda: router.replica_states()["r0"]["ready"], 10)
    finally:
        router.close()
        for s in (a, b, c):
            s.close()


def test_router_ejection_and_halfopen_readmission():
    class _Clock:
        def __init__(self):
            self.t = time.monotonic()

        def __call__(self):
            return self.t

        def advance(self, dt):
            self.t += dt

    clock = _Clock()
    a = _StubReplica(infer_mode="fail")
    b = _StubReplica()
    router = Router(replicas=[a.url, b.url], poll_interval_s=0.05,
                    eject_threshold=2, eject_cooldown_s=0.4,
                    retry_budget=2, hedge_ms=0, clock=clock)
    httpd = router.start(port=0)
    try:
        assert _wait(lambda: _all_ready(router, 2), 10)
        for _ in range(3):
            assert _post(httpd.port, "/v1/infer", {"feed": {}})[0] == 200
        snap = router.metrics.snapshot()
        assert snap["ejections_total"].get("r0") == 1
        assert snap["retries_total"] >= 2
        assert router.replica_states()["r0"]["breaker"] != "closed"
        hits = a.infer_hits
        _post(httpd.port, "/v1/infer", {"feed": {}})
        assert a.infer_hits == hits             # ejected: not dialed
        a.infer_mode = "ok"
        clock.advance(0.5)
        assert _post(httpd.port, "/v1/infer", {"feed": {}})[0] == 200
        assert _wait(lambda: router.metrics.snapshot()
                     ["readmissions_total"].get("r0") == 1, 10)
        assert router.replica_states()["r0"]["breaker"] == "closed"
    finally:
        router.close()
        a.close()
        b.close()


def test_router_dispatch_fault_point():
    fires = []
    for plan in (FaultPlan.from_spec("router.dispatch:p=0.5,seed=9"),
                 FaultPlan.from_spec("router.dispatch:p=0.5,seed=9")):
        row = []
        for _ in range(64):
            try:
                plan.hit("router.dispatch")
                row.append(0)
            except Exception:       # noqa: BLE001 — the injected fault
                row.append(1)
        fires.append(row)
    assert fires[0] == fires[1] and sum(fires[0]) > 0
    a = _StubReplica()
    router = Router(replicas=[a.url], poll_interval_s=0.05, retry_budget=2,
                    hedge_ms=0)
    httpd = router.start(port=0)
    try:
        assert _wait(router.ready, 10)
        faults.install_spec("router.dispatch:at=1")
        st, out = _post(httpd.port, "/v1/infer", {"feed": {}})
        assert st == 200 and "outputs" in out
        assert faults.fired_counts()["router.dispatch"] == 1
        snap = router.metrics.snapshot()
        assert snap["retries_total"] == 1
        assert snap["dispatch_errors_total"].get("r0") == 1
    finally:
        router.close()
        a.close()


def test_router_hedged_infer():
    a = _StubReplica(infer_delay_s=0.6)     # r0: the slow primary
    b = _StubReplica()
    router = Router(replicas=[a.url, b.url], poll_interval_s=0.05,
                    hedge_ms=40, retry_budget=1)
    httpd = router.start(port=0)
    try:
        assert _wait(lambda: _all_ready(router, 2), 10)
        t0 = time.perf_counter()
        st, out = _post(httpd.port, "/v1/infer", {"feed": {}})
        assert st == 200 and "outputs" in out
        assert time.perf_counter() - t0 < 0.55
        snap = router.metrics.snapshot()
        assert snap["hedges_total"] == 1 and snap["hedge_wins_total"] == 1
    finally:
        router.close()
        a.close()
        b.close()


def test_router_sheds_lowest_class_first_with_retry_after():
    stub = _Stub(infer_delay_s=0.6)
    ctl = OverloadController(limiter=AIMDLimiter(initial=3, min_limit=1))
    router = Router(replicas=[stub.url], poll_interval_s=0.05, hedge_ms=0,
                    overload=ctl)
    httpd = router.start(port=0)
    try:
        assert _wait(router.ready, 10)
        results = {}

        def infer(tag):
            results[tag] = _post_raw(httpd.port, "/v1/infer", {"feed": {}},
                                     {"X-Priority": "standard"})

        slow = [threading.Thread(target=infer, args=(i,)) for i in range(2)]
        for t in slow:
            t.start()
        assert _wait(lambda: ctl.limiter.inflight >= 2, 5)
        st, hd, data = _post_raw(httpd.port, "/v1/infer", {"feed": {}},
                                 {"X-Priority": "background"})
        assert st == 429 and int(hd["Retry-After"]) >= 1
        assert json.loads(data)["priority"] == "background"
        assert _post_raw(httpd.port, "/v1/infer", {"feed": {}},
                         {"X-Priority": "interactive"})[0] == 200
        for t in slow:
            t.join(30)
        assert all(r[0] == 200 for r in results.values())
        assert router.metrics.snapshot()["rejected"]["shed"] == 1
        osnap = ctl.snapshot()
        assert osnap["shed_total"]["background"] == 1
        assert osnap["admitted_total"]["interactive"] == 1
        mtext = router.render_prometheus()
        assert 'overload_shed_total{priority="background"} 1' in mtext
    finally:
        router.close()
        stub.close()


def test_brownout_effects_in_router():
    """Rung 1 suppresses hedging, rung 2 caps a generate's max_tokens on
    the wire, rung 3 sheds background generates; walking back down
    restores full service."""

    class _Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clk = _Clock()
    stub = _Stub(gen_tokens=list(range(40)))
    lad = BrownoutLadder(slo_ttft_s=0.1, enter_hold_s=1.0, exit_hold_s=1.0,
                         clock=clk)
    ctl = OverloadController(ladder=lad, brownout_max_tokens=5, clock=clk)
    router = Router(replicas=[stub.url], poll_interval_s=0.05, hedge_ms=40,
                    overload=ctl)
    httpd = router.start(port=0)
    try:
        assert _wait(router.ready, 10)
        for _ in range(8):
            lad.observe(1.0)
            clk.t += 1.0
        assert lad.rung == 3
        st, _hd, data = _post_raw(httpd.port, "/v1/generate",
                                  {"prompt": [1, 2, 3], "max_tokens": 30})
        assert st == 200 and stub.gen_bodies[-1]["max_tokens"] == 5
        assert len(json.loads(data)["tokens"]) == 5
        st, hd, _ = _post_raw(httpd.port, "/v1/generate",
                              {"prompt": [1], "max_tokens": 3,
                               "priority": "background"})
        assert st == 429 and "Retry-After" in hd
        stub.infer_delay_s = 0.3
        assert _post_raw(httpd.port, "/v1/infer", {"feed": {}})[0] == 200
        assert router.metrics.snapshot()["hedges_total"] == 0
        assert ctl.hedges_suppressed_total >= 1
        for _ in range(5):
            lad.observe(0.01)
            clk.t += 1.0
        assert lad.rung == 0
        st, _hd, data = _post_raw(httpd.port, "/v1/generate",
                                  {"prompt": [1, 2], "max_tokens": 8,
                                   "priority": "background"})
        assert st == 200 and len(json.loads(data)["tokens"]) == 8
    finally:
        router.close()
        stub.close()


def test_autoscaler_lines_on_the_router_page():
    class _Sup:
        replicas = {"r0": object()}

    stub = _Stub()
    router = Router(replicas=[stub.url], poll_interval_s=0.05, hedge_ms=0)
    scaler = Autoscaler(_Sup(), router, poll_interval_s=1.0,
                        target_ttft_ms=500.0, min_replicas=1,
                        max_replicas=2, seed=7)
    try:
        router.metrics.observe_ttft(0.01)
        scaler.tick()
        text = router.render_prometheus()
        assert "autoscaler_replicas 1" in text
        assert 'autoscaler_decisions_total{direction="hold"} 1' in text
        scaler.close()
        assert "autoscaler_replicas" not in router.render_prometheus()
    finally:
        router.close()
        stub.close()


# ------------------------------------------------ in-process port replicas


def test_midstream_failover_bit_identical(jax_ref, replica):
    """A replica that dies mid-stream (4 tokens out, then RST): the
    router resubmits prompt + delivered tokens as a continuation on the
    healthy port replica — the client's stream is bit for bit the
    replica's uninterrupted stream, which equals JAX's lm_generate up to
    the margin."""
    gen, _httpd, url = replica
    prompt = FAILOVER_PROMPT
    clean = gen.submit(prompt, max_tokens=10).result(60)["tokens"]
    stub = _StubReplica(gen_tokens=clean, die_after=4)
    router = Router(replicas=[stub.url, url], poll_interval_s=0.05,
                    retry_budget=2, hedge_ms=0)
    httpd = router.start(port=0)
    try:
        assert _wait(lambda: _all_ready(router, 2), 10)
        toks, done = _stream(httpd.port, {"prompt": prompt,
                                          "max_tokens": 10, "stream": True})
        assert toks == clean and done["tokens"] == clean
        snap = router.metrics.snapshot()
        assert snap["midstream_failovers_total"] == 1
        assert snap["tokens_proxied_total"] == 10
        assert router.metrics.ttft.count == 1
    finally:
        router.close()
        stub.close()
    assert _agree_with_jax([clean], jax_ref, [0]) >= 5


def test_drained_replica_dies_midstream_failover(replica):
    """A replica being drained (unready after its first token, stream
    still attached) that dies before the drain ends: the failover still
    finishes the stream bit for bit."""
    gen, _httpd, url = replica
    prompt = np.random.RandomState(5).randint(1, VOCAB, 6).tolist()
    clean = gen.submit(prompt, max_tokens=10).result(60)["tokens"]
    victim = _Stub(gen_tokens=clean, die_after=4)
    router = Router(replicas=[victim.url, url], poll_interval_s=0.05,
                    retry_budget=2, hedge_ms=0)
    httpd = router.start(port=0)
    try:
        assert _wait(lambda: _all_ready(router, 2), 10)

        def first(n):
            if n == 1:
                victim.ready = False

        toks, done = _stream_generate(httpd.port, prompt, 10, on_token=first)
        assert toks == clean and done["tokens"] == clean
        assert router.metrics.snapshot()["midstream_failovers_total"] == 1
    finally:
        router.close()
        victim.close()


def test_client_disconnect_propagates_abandon(replica):
    gen, _httpd, url = replica
    engine = gen.engine
    engine.metrics = gen.metrics = ServingMetrics()
    router = Router(replicas=[url], poll_interval_s=0.05, hedge_ms=0)
    httpd = router.start(port=0)
    faults.install_spec("serving.decode_step:every=1,action=hang,"
                        "hang_s=0.02")
    try:
        assert _wait(router.ready, 10)
        prompt = np.random.RandomState(8).randint(1, VOCAB, 5).tolist()
        toks, done = _stream(httpd.port, {"prompt": prompt,
                                          "max_tokens": 30, "stream": True},
                             close_after=2)
        assert done is None and len(toks) >= 2
        assert _wait(lambda: gen.metrics.snapshot()["evictions"]
                     ["abandoned"] >= 1, 30), gen.metrics.snapshot()
        assert _wait(lambda: engine.free_slots == engine.num_slots, 30)
        assert _wait(lambda: router.metrics.snapshot()
                     ["client_disconnects_total"] >= 1, 10)
    finally:
        faults.clear()
        router.close()


def _count(text, outcome):
    import re
    m = re.search(r'^\S*_kv_handoffs_total\{outcome="' + outcome
                  + r'"\} (\d+)\s*$', text, re.MULTILINE)
    return int(m.group(1)) if m else 0


def test_prefill_decode_handoff_and_both_fallbacks(jax_ref, tparams):
    """One prefill-role and one decode-role port replica (paged, block 8,
    prefix cache, host tier): every new stream prefills on the first,
    is handed to the second at its first token, and is bit for bit a
    mixed engine's (and JAX's up to the margin); the handoff counters
    show on both replicas and on the router; a prompt below the analytic
    crossover takes the recompute fallback; after the prefill replica is
    closed, a handoff against the dead source falls back and stays bit
    for bit."""
    kw = dict(prefill_chunk=BS, kv_layout="paged", kv_block_size=BS,
              kv_num_blocks=49, prefix_cache=True, kv_host_bytes=64 << 20)
    lengths, prompts, n_tok = HANDOFF_LENGTHS, HANDOFF_PROMPTS, N_TOK
    ref_eng = _engine(tparams, "mixed_ref", **kw)
    with GenerationBatcher(ref_eng) as ref:
        oracle = [ref.submit(p, max_tokens=n_tok).result(60)["tokens"]
                  for p in prompts]
    handed = [ref_eng._handoff_predicted_faster(n // BS * BS)[0]
              for n in lengths]
    assert handed == [True, True, False, True]
    pgen, phttpd, purl = _serve(_engine(tparams, "prefill_lm", **kw),
                                "prefill")
    dgen, dhttpd, durl = _serve(_engine(tparams, "decode_lm", **kw),
                                "decode")
    router = Router(replicas=[purl, durl], poll_interval_s=0.05,
                    retry_budget=3, hedge_ms=0)
    httpd = router.start(port=0)
    try:
        assert _wait(router.disagg_active, 10)
        results = [None] * len(lengths)

        def hit(i):
            results[i] = _stream(httpd.port, {"prompt": prompts[i],
                                              "max_tokens": n_tok,
                                              "stream": True})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(lengths))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for i, (toks, done) in enumerate(results):
            assert toks == oracle[i] and done["tokens"] == oracle[i], i
        outcomes = [done["kv_handoff"]["outcome"] for _t, done in results]
        assert outcomes == ["received" if h else "fallback"
                            for h in handed]
        with urllib.request.urlopen(f"{purl}/metrics") as r:
            ptext = r.read().decode()
        with urllib.request.urlopen(f"{durl}/metrics") as r:
            dtext = r.read().decode()
        assert _count(ptext, "sent") == 3 and _count(dtext, "received") == 3
        assert _count(dtext, "fallback") == 1
        assert '_serving_role{role="prefill"} 1' in ptext
        dsnap = dgen.metrics.snapshot()
        assert dsnap["kv_handoff_bytes_total"] > 0
        assert dsnap["kv_restore_hits_total"] == 3
        snap = router.metrics.snapshot()
        assert snap["kv_handoffs_total"] == {"sent": 0, "received": 3,
                                             "fallback": 1}
        assert snap["kv_handoff_bytes_total"] == \
            dsnap["kv_handoff_bytes_total"]
        assert snap["kv_handoff_ms"]["p50"] > 0
        # the prefill replica goes away: a handoff naming it falls back
        _stop(pgen, phttpd)
        p, o = prompts[-1], oracle[-1]
        toks, done = _stream_generate(
            dhttpd.port, p, n_tok - 1, replay=o[:1],
            handoff={"source": purl, "tokens": p})
        assert toks == o[1:] and done["tokens"] == o[1:]
        assert done["kv_handoff"]["outcome"] == "fallback"
        with urllib.request.urlopen(f"{durl}/metrics") as r:
            assert _count(r.read().decode(), "fallback") == 2
        # the fleet keeps serving through the loss, on what is left
        toks, done = _stream(httpd.port, {"prompt": p, "max_tokens": n_tok,
                                          "stream": True})
        assert toks == o
    finally:
        router.close()
        _stop(dgen, dhttpd)
    assert _agree_with_jax(oracle, jax_ref, range(1, len(prompts) + 1)) \
        >= 0.5 * n_tok * len(prompts)


# ---------------------------------------------------- metrics and surface


class _SimClock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _scripted_metrics(mod, clk):
    """The same events on a router of either package, over one address
    nobody serves (the replica stays unready on both)."""
    router = mod.Router(replicas=["http://127.0.0.1:9"],
                        poll_interval_s=3600.0, hedge_ms=0, clock=clk)
    m = router.metrics
    for route in ("infer", "infer", "generate"):
        m.accepted(route)
    for reason in ("unready", "shed", "shed"):
        m.reject(reason)
    for dt in (0.1, 0.25, 0.3, 0.05):
        m.observe_response(dt)
        clk.t += 0.5
    for dt in (0.04, 0.07, 0.02):
        m.observe_ttft(dt)
    m.observe_kv_handoff("received", 4096, 0.012)
    m.observe_kv_handoff("fallback")
    for field in ("retries_total", "failovers_total",
                  "midstream_failovers_total", "hedges_total",
                  "client_disconnects_total"):
        m.count(field)
    m.count("tokens_proxied_total", 37)
    m._bump(m.dispatch_total, "r0", 3)
    m._bump(m.dispatch_errors_total, "r0")
    m._bump(m.ejections_total, "r0")
    router.overload.admit("interactive")
    router.overload.release(completed=True)
    for pr in ("standard", "background"):
        router.overload.admit(pr)
    router.overload.release(overloaded=True)
    return router


def test_router_metrics_render_equal_to_jax():
    routers = [_scripted_metrics(mod, _SimClock())
               for mod in (jax_router, torch_router)]
    try:
        jr, tr = routers
        jsnap, tsnap = jr.metrics.snapshot(), tr.metrics.snapshot()
        assert tsnap == jsnap
        assert tr.render_prometheus() == jr.render_prometheus()
        assert tr.metrics.slo_p99_recent_s(10) \
            == jr.metrics.slo_p99_recent_s(10)
    finally:
        for r in routers:
            r.close()
    assert torch_router._QDEPTH_RE.pattern == jax_router._QDEPTH_RE.pattern
    assert torch_router._ROLE_RE.pattern == jax_router._ROLE_RE.pattern
    assert torch_router.ROUTER_REJECT_REASONS \
        == jax_router.ROUTER_REJECT_REASONS


def test_replica_metrics_lines_parse_with_the_routers_regexes():
    m = ServingMetrics()
    m.set_serving_role("decode")
    m.queue_depth_fns.append(lambda: 3)
    text = m.render_prometheus()
    assert torch_router._QDEPTH_RE.search(text).group(1) == "3"
    assert torch_router._ROLE_RE.search(text).group(1) == "decode"


def test_serving_all_covers_jax():
    assert set(jax_serving.__all__) <= set(torch_serving.__all__)
    for name in torch_serving.__all__:
        assert getattr(torch_serving, name) is not None, name
    with pytest.raises(ValueError):
        Router()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_router_cli_serves_a_cpu_replica():
    """``python -m paddle_tpu_torch.serving.router --replicas 1
    --replica-arg=--device --replica-arg=cpu`` routes /v1/generate and
    stops its fleet on SIGTERM."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.router",
         "--replicas", "1", "--replica-arg=--device",
         "--replica-arg=cpu", "--port", str(port)],
        cwd=_ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"

    def ready():
        try:
            with urllib.request.urlopen(f"{base}/readyz", timeout=2) as r:
                return r.status == 200
        except Exception:           # noqa: BLE001 — not up yet
            return False

    try:
        assert _wait(ready, 120, every=0.2)
        req = urllib.request.Request(
            f"{base}/v1/generate",
            data=json.dumps({"prompt": [1, 2, 3],
                             "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert len(out["tokens"]) == 4
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert 'replica_ready{replica="r0"} 1' in r.read().decode()
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, proc.stderr.read()[-2000:]
