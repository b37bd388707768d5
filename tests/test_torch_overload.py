"""The router's overload control on the port (``serving/overload.py``)
held against JAX's: ``AIMDLimiter``, ``BrownoutLadder``, ``DrainRate``
and ``OverloadController`` driven through the same scripted event
sequences on one simulated clock each, every return value, every shed
(reason, Retry-After, class) and every snapshot equal after each event,
and ``render_lines`` equal at the end.  Pure host code: no device."""

import numpy as np
import pytest

from paddle_tpu.serving import overload as jax_ov
from paddle_tpu_torch.serving import overload as torch_ov

PACKAGES = {"jax": jax_ov, "torch": torch_ov}


class SimClock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)
        return self.t


def _controller(ov, clk, initial=4.0, slo_s=0.5, max_tokens=5):
    return ov.OverloadController(
        limiter=ov.AIMDLimiter(initial=initial, min_limit=1, max_limit=16,
                               increase=1.0, decrease=0.5,
                               decrease_cooldown_s=1.0, clock=clk),
        ladder=ov.BrownoutLadder(slo_ttft_s=slo_s, enter_hold_s=2.0,
                                 exit_hold_s=3.0, clock=clk),
        drain_window_s=10.0, brownout_max_tokens=max_tokens, clock=clk)


def _script(seed, n=300):
    """A seeded event sequence: admissions by class with and without a
    deadline, releases (clean, overloaded, failed), SLO readings around
    the target, clock steps, and the brownout taps."""
    rng = np.random.RandomState(seed)
    events = []
    for _ in range(n):
        kind = rng.choice(["admit", "admit", "release", "release", "slo",
                           "advance", "hedge", "cap", "retry_after"])
        if kind == "admit":
            pr = rng.choice(["interactive", "standard", "background",
                             "BACKGROUND", "bogus", None])
            dl = None if rng.rand() < 0.6 else float(rng.choice(
                [50, 500, 2000, 20000]))
            events.append(("admit", pr, dl))
        elif kind == "release":
            events.append(("release", bool(rng.rand() < 0.3),
                           bool(rng.rand() < 0.8)))
        elif kind == "slo":
            events.append(("slo", float(rng.choice([0.1, 0.4, 0.6, 2.0]))))
        elif kind == "advance":
            events.append(("advance", float(rng.choice([0.1, 0.5, 1.0,
                                                        2.5]))))
        elif kind == "cap":
            events.append(("cap", int(rng.randint(1, 40))))
        else:
            events.append((kind,))
    return events


def _run(ov, events):
    clk = SimClock(100.0)
    ctl = _controller(ov, clk)
    log = []
    held = 0
    for ev in events:
        kind = ev[0]
        if kind == "admit":
            try:
                got = ("admitted", ctl.admit(ev[1], deadline_ms=ev[2]))
                held += 1
            except ov.ShedError as e:
                got = ("shed", e.reason, e.retry_after_s, e.priority,
                       str(e))
        elif kind == "release":
            if held:
                ctl.release(overloaded=ev[1], completed=ev[2])
                held -= 1
            got = held
        elif kind == "slo":
            got = ctl.observe_slo(ev[1])
        elif kind == "advance":
            got = clk.advance(ev[1])
        elif kind == "hedge":
            got = ctl.hedging_allowed()
        elif kind == "cap":
            got = ctl.cap_max_tokens(ev[1])
        else:
            got = ctl.retry_after_s()
        log.append((ev, got, ctl.snapshot()))
    return log, ctl.render_lines("paddle_tpu_router")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_script_equal_to_jax(seed):
    events = _script(seed)
    jlog, jlines = _run(jax_ov, events)
    tlog, tlines = _run(torch_ov, events)
    for (ev, jg, js), (_ev, tg, ts) in zip(jlog, tlog):
        assert tg == jg, ev
        assert ts == js, ev
    assert tlines == jlines
    # the script reached the ladder's rungs and both shed reasons
    kinds = {g[1] for _e, g, _s in tlog
             if isinstance(g, tuple) and g[0] == "shed"}
    assert kinds & {"limit", "brownout"}, kinds
    assert max(s["brownout"]["rung"] for _e, _g, s in tlog) >= 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_brownout_ladder_exact_rung_sequences(pkg):
    """Rung entry/exit counters, exactly, on both packages: sustained
    breach climbs one rung per hold period, sustained health walks back
    down one rung per exit period, a short blip moves nothing, and a
    disabled ladder is inert."""
    ov = PACKAGES[pkg]
    clk = SimClock(0.0)
    lad = ov.BrownoutLadder(slo_ttft_s=0.5, enter_hold_s=2.0,
                            exit_hold_s=3.0, clock=clk)
    rungs = []
    for _ in range(9):
        rungs.append(lad.observe(1.0))
        clk.advance(1.0)
    assert rungs == [0, 0, 1, 1, 2, 2, 3, 3, 3]
    assert lad.entries == {"hedge_off": 1, "token_cap": 1,
                           "shed_background": 1}
    assert not lad.hedging_allowed() and lad.shed_background()
    rungs = []
    for _ in range(11):
        rungs.append(lad.observe(0.1))
        clk.advance(1.0)
    assert rungs == [3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0]
    assert lad.exits == {"hedge_off": 1, "token_cap": 1,
                         "shed_background": 1}
    lad.observe(1.0)
    clk.advance(1.0)
    assert lad.observe(0.1) == 0 and lad.entries["hedge_off"] == 1
    off = ov.BrownoutLadder(slo_ttft_s=0.0, clock=clk)
    for _ in range(10):
        assert off.observe(99.0) == 0
        clk.advance(5.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_aimd_limiter_increase_decrease_and_class_order(pkg):
    ov = PACKAGES[pkg]
    clk = SimClock()
    lim = ov.AIMDLimiter(initial=3, min_limit=1, max_limit=8,
                         decrease_cooldown_s=1.0, clock=clk)
    for _ in range(2):
        assert lim.try_acquire("standard")        # 0,1 < 2.55
    assert not lim.try_acquire("background")      # 2 >= 1.8: shed first
    assert lim.try_acquire("interactive")         # 2 < 3
    assert not lim.try_acquire("interactive")     # 3 >= 3: full
    lim.release(overloaded=True)
    assert lim.limit == 1.5 and lim.decreases_total == 1
    lim.release(overloaded=True)                  # same congestion event
    assert lim.limit == 1.5 and lim.decreases_total == 1
    clk.advance(2.0)
    lim.release(overloaded=True)
    assert lim.limit == 1.0                       # floored at min_limit
    lim2 = ov.AIMDLimiter(initial=2, increase=1.0, clock=clk)
    lim2.try_acquire()
    lim2.release()
    assert lim2.limit == pytest.approx(2.5)
    lim2.try_acquire()
    lim2.release(success=False)                   # a failure: no move
    assert lim2.limit == pytest.approx(2.5)
    with pytest.raises(ValueError):
        ov.AIMDLimiter(decrease=1.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_retry_after_and_deadline_shed(pkg):
    """Retry-After = excess in-flight over the observed drain rate; a
    deadline that cannot survive the estimated queue wait sheds at
    once, and at healthy concurrency no deadline sheds."""
    ov = PACKAGES[pkg]
    clk = SimClock(0.0)
    ctl = ov.OverloadController(limiter=ov.AIMDLimiter(initial=2,
                                                       clock=clk),
                                drain_window_s=10.0, clock=clk)
    for _ in range(8):
        ctl.drain.observe()
        clk.advance(0.5)
    assert ctl.drain.rate() == pytest.approx(2.0, rel=0.3)
    ctl.limiter.inflight = 6
    ra = ctl.retry_after_s()
    assert 2 <= ra <= 4, ra
    with pytest.raises(ov.ShedError) as ei:
        ctl.admit("standard")
    assert ei.value.reason == "limit" and ei.value.retry_after_s == ra
    ctl2 = ov.OverloadController(limiter=ov.AIMDLimiter(initial=4,
                                                        clock=clk),
                                 drain_window_s=10.0, clock=clk)
    for _ in range(10):
        ctl2.drain.observe()
        clk.advance(1.0)
    ctl2.limiter.inflight = 8
    with pytest.raises(ov.ShedError) as ei:
        ctl2.admit("interactive", deadline_ms=2000)
    assert ei.value.reason == "deadline"
    ctl2.limiter.inflight = 2
    assert ctl2.admit("interactive", deadline_ms=100) == "interactive"
    assert ov.DrainRate(clock=SimClock()).rate() == 0.0


def test_module_surface_matches_jax():
    for name in ("PRIORITY_CLASSES", "DEFAULT_PRIORITY", "CLASS_HEADROOM",
                 "BROWNOUT_RUNGS"):
        assert getattr(torch_ov, name) == getattr(jax_ov, name), name
    assert torch_ov.OverloadController.parse_priority("Interactive") \
        == jax_ov.OverloadController.parse_priority("Interactive")
