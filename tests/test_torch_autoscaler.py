"""The autoscaler on the port (``serving/autoscaler.py``) held against
JAX's: the control law over scripted stub fleets on a SIMULATED clock
(the stub fleet and clock of ``tests/test_autoscaler.py``, each package
hitting its own ``fleet.spawn`` fault point), the scripted breach ->
chaos -> recovery -> slack scenario's decision journal equal line for
line to JAX's, the hard bounds, flap-freedom, the ``autoscaler.scale``
and ``fleet.spawn`` fault points with their seeded retries, and the
windowed SLO signal (``Histogram`` with a clock, ``RouterMetrics.
slo_p99_recent_s``).  Pure host code: no device, no subprocess."""

import random

import pytest

from paddle_tpu.resilience import faults as jax_faults
from paddle_tpu.serving import autoscaler as jax_as
from paddle_tpu.serving import router as jax_router
from paddle_tpu.utils import stats as jax_stats
from paddle_tpu_torch.resilience import faults as torch_faults
from paddle_tpu_torch.serving import autoscaler as torch_as
from paddle_tpu_torch.serving import router as torch_router
from paddle_tpu_torch.utils import stats as torch_stats

PACKAGES = {"jax": (jax_as, jax_router, jax_faults),
            "torch": (torch_as, torch_router, torch_faults)}


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    jax_faults.clear()
    torch_faults.clear()


class SimClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)
        return self.t


class StubSupervisor:
    """A scripted ReplicaSupervisor: add/remove bookkeeping without
    subprocesses; ``add_replica`` fires its package's ``fleet.spawn``
    fault point, as the real one does."""

    def __init__(self, faults, n=1, ready=True):
        self.faults = faults
        self.replicas = {f"r{i}": object() for i in range(n)}
        self._next = n
        self.added, self.removed = [], []
        self.ready = ready

    def add_replica(self):
        self.faults.hit("fleet.spawn")
        rid = f"r{self._next}"
        self._next += 1
        self.replicas[rid] = object()
        self.added.append(rid)
        return rid

    def remove_replica(self, rid, drain_timeout=60.0):
        self.replicas.pop(rid)
        self.removed.append(rid)

    def wait_ready(self, timeout=0.0, rids=None):
        return self.ready


class StubRouterView:
    """The router surface the autoscaler reads: a real RouterMetrics
    (sim-clocked windows) and a scriptable replica_states()."""

    def __init__(self, router_mod, clock):
        self.metrics = router_mod.RouterMetrics(clock=clock)
        self.extra_render_fns = []
        self.states = {"r0": {"ready": True, "queue_depth": 0,
                              "inflight": 0, "breaker": "closed"}}

    def replica_states(self):
        return {rid: dict(st) for rid, st in self.states.items()}

    def set_replica(self, rid, ready=True, queue_depth=0, inflight=0,
                    breaker="closed"):
        self.states[rid] = {"ready": ready, "queue_depth": queue_depth,
                            "inflight": inflight, "breaker": breaker}


def make(pkg, n=1, ready=True, clk=None, **kw):
    asm, rmod, faults = PACKAGES[pkg]
    clk = clk or SimClock()
    sup = StubSupervisor(faults, n, ready=ready)
    router = StubRouterView(rmod, clk)
    base = dict(poll_interval_s=1.0, target_ttft_ms=500.0, hysteresis=0.2,
                breach_polls=3, slack_polls=4, cooldown_out_s=5.0,
                cooldown_in_s=20.0, min_replicas=1, max_replicas=3,
                window_s=10.0, seed=7, ready_timeout_s=1.0, clock=clk)
    base.update(kw)
    return asm.Autoscaler(sup, router, **base), sup, router, clk, faults


def feed_ttft(router, ms, n=5):
    for _ in range(n):
        router.metrics.observe_ttft(ms / 1e3)


def _scripted_run(pkg, seed):
    """breach -> chaos (fleet.spawn fails once) -> recovery -> slack on
    a fresh sim-clocked stub fleet; returns the journal lines and the
    rendered autoscaler_* lines."""
    a, sup, router, clk, faults = make(
        pkg, clk=SimClock(50.0), breach_polls=2, slack_polls=3,
        cooldown_out_s=2.0, cooldown_in_s=6.0, seed=seed, retry_base_s=0.5,
        window_s=4.0, max_replicas=3)
    faults.clear()
    faults.install_spec("fleet.spawn:at=2")
    script = [2000] * 8 + [100] * 4 + [2000] * 6 + [10] * 14
    for ms in script:
        router.metrics.observe_ttft(ms / 1e3)
        for rid in list(sup.replicas):
            router.set_replica(rid, inflight=1 if ms > 500 and
                               rid == "r0" else 0)
        a.tick()
        clk.advance(1.0)
    faults.clear()
    return a.journal_lines(), a.render_lines()


@pytest.mark.parametrize("seed", [21, 22])
def test_decision_journal_equal_to_jax_line_for_line(seed):
    jlines, jrender = _scripted_run("jax", seed)
    tlines, trender = _scripted_run("torch", seed)
    assert len(tlines) == len(jlines)
    for i, (t, j) in enumerate(zip(tlines, jlines)):
        assert t == j, i
    assert trender == jrender
    assert any('"decision": "out"' in ln for ln in tlines)
    assert any('"decision": "in"' in ln for ln in tlines)
    assert any('"ok": false' in ln for ln in tlines)   # the chaos leg


def test_journal_replays_and_seed_is_load_bearing():
    run1, _ = _scripted_run("torch", 21)
    assert run1 == _scripted_run("torch", 21)[0]
    assert _scripted_run("torch", 22)[0] != run1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_scale_out_on_sustained_breach_only(pkg):
    a, sup, router, clk, _f = make(pkg, breach_polls=3)
    feed_ttft(router, 2000)
    decisions = []
    for _ in range(4):
        decisions.append(a.tick()["decision"])
        clk.advance(1.0)
    assert decisions[:3] == ["hold", "hold", "out"]
    assert sup.added == ["r1"] and a.scales_total["out"] == 1
    # one transient blip never scales: the streak resets on health
    b, sup2, router2, clk2, _f = make(pkg, clk=clk, breach_polls=3,
                                      window_s=0.5)
    for i in range(6):
        router2.metrics.observe_ttft(2.0 if i % 2 == 0 else 0.05)
        b.tick()
        clk2.advance(1.0)
    assert sup2.added == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_max_and_min_bounds_are_hard(pkg):
    a, sup, router, clk, _f = make(pkg, n=2, breach_polls=1,
                                   max_replicas=2, cooldown_out_s=0.0)
    router.set_replica("r1")
    feed_ttft(router, 2000)
    e = a.tick()
    assert e["decision"] == "hold" and "max_replicas" in e["reason"]
    assert sup.added == []
    b, sup2, router2, clk2, _f = make(pkg, slack_polls=1, min_replicas=1,
                                      cooldown_in_s=0.0)
    feed_ttft(router2, 10)
    for _ in range(5):
        assert b.tick()["decision"] == "hold"
        clk2.advance(1.0)
    assert sup2.removed == []
    with pytest.raises(ValueError):
        make(pkg, min_replicas=3, max_replicas=2)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_victim_choice_idle_then_dead_first(pkg):
    a, sup, router, clk, _f = make(pkg, n=2, slack_polls=2,
                                   cooldown_in_s=0.0)
    router.set_replica("r0", inflight=3)
    router.set_replica("r1", inflight=0)
    feed_ttft(router, 10)
    a.tick()
    clk.advance(1.0)
    assert a.tick()["decision"] == "in" and sup.removed == ["r1"]
    b, sup2, router2, _clk, _f = make(pkg, n=2, slack_polls=1,
                                      cooldown_in_s=0.0)
    router2.set_replica("r0", ready=True, inflight=0)
    router2.set_replica("r1", ready=False)
    feed_ttft(router2, 10)
    assert b.tick()["decision"] == "in" and sup2.removed == ["r1"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_total_stall_no_signal_never_reads_as_slack(pkg):
    a, sup, router, clk, _f = make(pkg, n=2, slack_polls=1,
                                   cooldown_in_s=0.0)
    router.set_replica("r0", inflight=3)
    router.set_replica("r1", inflight=2)
    for _ in range(5):
        e = a.tick()
        assert e["decision"] == "hold" and e["signals"]["ttft_p99_ms"] \
            is None
        clk.advance(1.0)
    router.set_replica("r0", inflight=0)
    router.set_replica("r1", inflight=0)
    e = a.tick()
    assert e["decision"] == "in" and "no-signal" in e["reason"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_flap_free_under_oscillating_load(pkg):
    """The replica count changes at most once per cooldown window."""
    a, sup, router, clk, _f = make(pkg, breach_polls=2, slack_polls=2,
                                   cooldown_out_s=4.0, cooldown_in_s=10.0,
                                   window_s=0.5, max_replicas=2)
    events = []
    for i in range(120):
        router.metrics.observe_ttft(2.0 if (i // 6) % 2 == 0 else 0.01)
        router.states = {rid: {"ready": True, "queue_depth": 0,
                               "inflight": 0, "breaker": "closed"}
                         for rid in sup.replicas}
        e = a.tick()
        if e["decision"] in ("out", "in"):
            events.append((e["t"], e["decision"]))
        clk.advance(1.0)
    assert events
    for (t1, _d1), (t2, d2) in zip(events, events[1:]):
        assert t2 - t1 >= (4.0 if d2 == "out" else 10.0), events


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_spawn_fault_retries_with_seeded_backoff(pkg):
    a, sup, router, clk, faults = make(pkg, breach_polls=1,
                                       cooldown_out_s=0.0, seed=13,
                                       retry_base_s=0.5, retry_max_s=4.0)
    router.set_replica("r0", queue_depth=4, inflight=2)
    feed_ttft(router, 2000)
    faults.install_spec("fleet.spawn:at=1")
    e = a.tick()
    assert e["decision"] == "out" and e["actuation"]["ok"] is False
    assert "InjectedFault" in e["actuation"]["error"]
    assert sup.added == [] and a.scale_failures_total == 1
    expect = round(0.5 * (0.5 + 0.5 * random.Random(13).random()), 4)
    assert e["actuation"]["retry_in_s"] == expect
    clk.advance(expect / 2)
    assert a.tick()["decision"] == "hold" and sup.added == []
    clk.advance(expect)
    e = a.tick()
    assert e["decision"] == "out" and e["actuation"]["ok"] is True
    assert sup.added == ["r1"]
    assert faults.fired_counts()["fleet.spawn"] == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_autoscaler_scale_fault_and_unready_replica(pkg):
    a, sup, router, clk, faults = make(pkg, breach_polls=1,
                                       cooldown_out_s=0.0,
                                       retry_base_s=0.1, retry_max_s=0.1)
    feed_ttft(router, 2000)
    faults.install_spec("autoscaler.scale:at=1")
    e = a.tick()
    assert e["actuation"]["ok"] is False and sup.added == []
    clk.advance(1.0)
    e = a.tick()
    assert e["actuation"]["ok"] is True and sup.added == ["r1"]
    assert faults.fired_counts()["autoscaler.scale"] == 1
    # a spawned replica that never reaches readiness is removed
    b, sup2, router2, _clk, _f = make(pkg, ready=False, breach_polls=1,
                                      cooldown_out_s=0.0)
    router2.set_replica("r0", queue_depth=4)
    feed_ttft(router2, 2000)
    e = b.tick()
    assert e["actuation"]["ok"] is False and "not ready" in \
        e["actuation"]["error"]
    assert sup2.added == ["r1"] and sup2.removed == ["r1"]
    assert len(sup2.replicas) == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_retry_abandoned_when_conditions_invert(pkg):
    a, sup, router, clk, faults = make(pkg, breach_polls=1,
                                       cooldown_out_s=0.0, window_s=2.0,
                                       retry_base_s=5.0, retry_max_s=5.0)
    feed_ttft(router, 2000)
    faults.install_spec("fleet.spawn:every=1")
    e = a.tick()
    assert e["decision"] == "out" and e["actuation"]["ok"] is False
    faults.clear()
    clk.advance(3.0)
    router.metrics.observe_ttft(0.01)
    clk.advance(3.0)
    router.metrics.observe_ttft(0.01)
    assert a.tick()["decision"] == "hold"
    for _ in range(5):
        clk.advance(1.0)
        router.metrics.observe_ttft(0.01)
        assert a.tick()["decision"] != "out"
    assert sup.added == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_render_lines_and_close_detach(pkg):
    a, sup, router, clk, _f = make(pkg)
    assert router.extra_render_fns == [a.render_lines]
    text = "\n".join(a.render_lines())
    assert "autoscaler_ttft_p99_ms NaN" in text
    feed_ttft(router, 10)
    a.tick()
    text = "\n".join(a.render_lines())
    assert "autoscaler_replicas 1" in text
    assert 'autoscaler_decisions_total{direction="hold"} 1' in text
    a.close()
    a.close()
    assert router.extra_render_fns == []


def test_histogram_windowed_percentiles_equal_to_jax():
    """The clock threaded into the port's Histogram: windowed
    percentiles expire on the simulated clock exactly as JAX's, and a
    clockless one refuses a window."""
    clk = SimClock(0.0)
    jh = jax_stats.Histogram("t", keep="last", clock=clk)
    th = torch_stats.Histogram("t", clock=clk)
    for i, dt in enumerate((0.0, 5.0, 1.0, 2.0, 3.0)):
        clk.advance(dt)
        jh.add(0.1 * (i + 1))
        th.add(0.1 * (i + 1))
        for w in (None, 1.5, 3.5, 100.0):
            assert th.percentiles((50, 99), window_s=w) \
                == jh.percentiles((50, 99), window_s=w)
            assert th.recent_samples(w) == jh.recent_samples(w)
    clk.advance(100)
    assert th.percentiles((99,), window_s=3)[99] == 0.0
    plain = torch_stats.Histogram("p")
    plain.add(2.0)
    assert plain.percentiles((50,))[50] == 2.0
    with pytest.raises(ValueError, match="clock"):
        plain.percentiles((50,), window_s=1)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_router_metrics_slo_signal_prefers_ttft(pkg):
    clk = SimClock()
    m = PACKAGES[pkg][1].RouterMetrics(clock=clk)
    assert m.slo_p99_recent_s(10) is None
    m.observe_response(0.4)
    assert m.slo_p99_recent_s(10) == pytest.approx(0.4)
    m.observe_ttft(0.05)
    assert m.slo_p99_recent_s(10) == pytest.approx(0.05)
    clk.advance(100)
    assert m.slo_p99_recent_s(10) is None
