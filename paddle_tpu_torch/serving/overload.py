"""Adaptive overload control for the router
(``paddle_tpu/serving/overload.py``, host code copied as it is).

The replica tier already defends itself — bounded queues 429, breakers
503 — but those are cliff-edge defenses: by the time a replica sheds,
every queued request behind it has already eaten the latency.  This
module is the router-side feedback layer that keeps the fleet INSIDE its
SLO while the autoscaler (serving/autoscaler.py) changes the fleet size
underneath it, in three coupled pieces:

* ``AIMDLimiter`` — a TCP-style additive-increase/multiplicative-
  decrease concurrency limit ahead of the dispatch path.  Every clean
  completion nudges the limit up by ``increase/limit`` (one full +1 per
  round of the window); every overload signal from upstream (replica
  429/503, a shed) multiplies it by ``decrease`` at most once per
  ``decrease_cooldown_s`` (one congestion event per RTT, not one per
  queued victim).  The limit converges to what the fleet actually
  sustains instead of a hand-tuned constant that is wrong at every
  fleet size.

* PRIORITY CLASSES with deadline-aware shedding — requests carry a
  class (``"priority"`` in the body or the ``X-Priority`` header):
  ``interactive`` > ``standard`` (default) > ``background``.  Lower
  classes see a smaller slice of the limit (``CLASS_HEADROOM``), so as
  load rises the lowest class is shed FIRST, and a request whose own
  deadline cannot survive the estimated queue wait (in-flight work over
  the observed drain rate) is shed immediately instead of timing out
  inside the fleet.  Every shed is an honest HTTP 429 with a
  Retry-After derived from the observed drain rate — the excess
  in-flight work divided by completions/second, not a constant.

* ``BrownoutLadder`` — graceful degradation under SUSTAINED SLO breach
  (TTFT p99 over ``slo_ttft_ms`` for ``enter_hold_s``), one rung at a
  time, each rung trading a little quality for a lot of capacity:

      rung 1  hedge_off         stop hedging (no duplicate work)
      rung 2  token_cap         cap per-request max_tokens
      rung 3  shed_background   shed ALL background-class traffic

  Recovery walks DOWN one rung per sustained-healthy ``exit_hold_s``,
  and every entry/exit bumps an explicit per-rung counter — the
  degradation is observable and provably reversible, never a silent
  quality cliff.  ``slo_ttft_ms=0`` (the default) disables the ladder;
  the limiter still runs but its default bounds are far above any
  normal load, so the router's default behavior is unchanged.

Everything takes an injectable monotonic ``clock`` and mutates only
under one lock, so control decisions replay bit-for-bit on a simulated
clock.
"""

import math
import threading
import time

# priority classes, highest first.  The default for unlabeled traffic is
# "standard" so explicitly-interactive traffic can be protected ABOVE
# the default and bulk traffic demoted below it.
PRIORITY_CLASSES = ("interactive", "standard", "background")
DEFAULT_PRIORITY = "standard"

# fraction of the AIMD limit each class may fill: background saturates
# (and sheds) first, interactive last — the shed order under pressure.
CLASS_HEADROOM = {"interactive": 1.0, "standard": 0.85, "background": 0.6}

# brownout rungs in entry order (rung k = RUNGS[k-1]; rung 0 = healthy)
BROWNOUT_RUNGS = ("hedge_off", "token_cap", "shed_background")


class ShedError(RuntimeError):
    """The overload controller refused this request (HTTP 429).  Carries
    the honest Retry-After (seconds, derived from the observed drain
    rate) and the shedding reason for the metrics/counters."""

    def __init__(self, msg, retry_after_s, reason, priority):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.reason = reason            # "limit" | "deadline" | "brownout"
        self.priority = priority


class DrainRate:
    """Observed request completion rate over a sliding window — the
    denominator of every honest Retry-After.  A bounded ring of
    completion timestamps under the injected clock.

    Deliberately NOT built on utils/stats.Histogram's clock-stamped
    ring: here the timestamps ARE the data (rate() needs the oldest
    in-window completion time for its span), while the Histogram ring
    stores value samples and only uses times for window filtering."""

    def __init__(self, window_s=30.0, max_samples=4096, clock=None):
        self.window_s = float(window_s)
        self.clock = clock or time.monotonic
        self._times = []
        self._max = int(max_samples)
        self._i = 0
        self._lock = threading.Lock()

    def observe(self):
        now = self.clock()
        with self._lock:
            if len(self._times) < self._max:
                self._times.append(now)
            else:
                self._times[self._i % self._max] = now
            self._i += 1

    def rate(self):
        """Completions per second over the window (0.0 when idle).  The
        span is floored at one second: a single batch landing its
        completions within a millisecond must read as "N per second at
        most", not a near-infinite rate that would silently disable
        deadline shedding."""
        now = self.clock()
        with self._lock:
            recent = [t for t in self._times if t >= now - self.window_s]
        if not recent:
            return 0.0
        span = max(now - min(recent), 1.0)
        return len(recent) / span


class AIMDLimiter:
    """Additive-increase / multiplicative-decrease concurrency limiter.

    acquire(priority) admits while the in-flight count is under the
    class's slice of the current limit; release(overloaded=...) returns
    the permit and drives the AIMD feedback.  All state under one lock,
    all time from the injected clock.
    """

    def __init__(self, initial=64, min_limit=4, max_limit=4096,
                 increase=1.0, decrease=0.5, decrease_cooldown_s=1.0,
                 clock=None):
        if not 0.0 < float(decrease) < 1.0:
            raise ValueError("decrease must be in (0, 1)")
        self.limit = float(initial)
        self.min_limit = float(min_limit)
        self.max_limit = float(max_limit)
        self.increase = float(increase)
        self.decrease = float(decrease)
        self.decrease_cooldown_s = float(decrease_cooldown_s)
        self.clock = clock or time.monotonic
        self.inflight = 0
        self.decreases_total = 0
        self._last_decrease = -math.inf
        self._lock = threading.Lock()

    def headroom(self, priority):
        return CLASS_HEADROOM.get(priority, CLASS_HEADROOM[
            DEFAULT_PRIORITY])

    def try_acquire(self, priority=DEFAULT_PRIORITY):
        """Take one permit if the class's slice has room; True/False."""
        with self._lock:
            if self.inflight < self.limit * self.headroom(priority):
                self.inflight += 1
                return True
            return False

    def release(self, overloaded=False, success=True):
        """Return the permit.  A CLEAN COMPLETION (success=True, not
        overloaded) grows the limit by increase/limit (≈ +increase per
        full window of completions); an overload signal halves it, at
        most once per cooldown so one congestion event is charged once,
        not once per victim.  A plain failure (replica 4xx/5xx, timeout,
        broken stream) moves the limit NOWHERE — an error storm is not
        evidence the fleet can take more concurrency."""
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            if overloaded:
                now = self.clock()
                if now - self._last_decrease >= self.decrease_cooldown_s:
                    self._last_decrease = now
                    self.limit = max(self.min_limit,
                                     self.limit * self.decrease)
                    self.decreases_total += 1
            elif success:
                self.limit = min(self.max_limit,
                                 self.limit + self.increase
                                 / max(self.limit, 1.0))

    def snapshot(self):
        with self._lock:
            return {"limit": round(self.limit, 2),
                    "inflight": self.inflight,
                    "decreases_total": self.decreases_total}


class BrownoutLadder:
    """Rung-by-rung graceful degradation under sustained SLO breach.

    ``observe(ttft_p99_s)`` is called from the router's poll loop with
    the recent-window TTFT p99; the ladder steps UP one rung after the
    breach has held ``enter_hold_s``, steps DOWN one rung after health
    has held ``exit_hold_s``, and never moves more than one rung per
    observation — with per-rung entry/exit counters so every transition
    is visible in /metrics.  ``slo_ttft_s`` <= 0 disables the ladder
    (rung pinned at 0)."""

    def __init__(self, slo_ttft_s=0.0, enter_hold_s=3.0, exit_hold_s=5.0,
                 clock=None):
        self.slo_ttft_s = float(slo_ttft_s)
        self.enter_hold_s = float(enter_hold_s)
        self.exit_hold_s = float(exit_hold_s)
        self.clock = clock or time.monotonic
        self.rung = 0                   # 0 = healthy .. len(RUNGS)
        self.entries = {r: 0 for r in BROWNOUT_RUNGS}
        self.exits = {r: 0 for r in BROWNOUT_RUNGS}
        self._breach_since = None
        self._healthy_since = None
        self._lock = threading.Lock()

    @property
    def enabled(self):
        return self.slo_ttft_s > 0

    def observe(self, ttft_p99_s, now=None):
        """One SLO evaluation; returns the (possibly new) rung."""
        if not self.enabled:
            return 0
        now = self.clock() if now is None else now
        breached = ttft_p99_s > self.slo_ttft_s
        with self._lock:
            if breached:
                self._healthy_since = None
                if self._breach_since is None:
                    self._breach_since = now
                if (now - self._breach_since >= self.enter_hold_s
                        and self.rung < len(BROWNOUT_RUNGS)):
                    rung_name = BROWNOUT_RUNGS[self.rung]
                    self.rung += 1
                    self.entries[rung_name] += 1
                    self._breach_since = now    # next rung needs its own
                    #                             sustained breach
            else:
                self._breach_since = None
                if self._healthy_since is None:
                    self._healthy_since = now
                if (now - self._healthy_since >= self.exit_hold_s
                        and self.rung > 0):
                    self.rung -= 1
                    self.exits[BROWNOUT_RUNGS[self.rung]] += 1
                    self._healthy_since = now   # one rung per hold period
            return self.rung

    # --- the three degradation switches the router consults ---

    def hedging_allowed(self):
        return self.rung < 1

    def capping_tokens(self):
        """True when rung >= 2: the router must cap per-request
        max_tokens (the cap VALUE lives on the OverloadController —
        ``cap_max_tokens`` applies it)."""
        return self.rung >= 2

    def shed_background(self):
        return self.rung >= 3

    def snapshot(self):
        with self._lock:
            return {"rung": self.rung,
                    "entries": dict(self.entries),
                    "exits": dict(self.exits)}


class OverloadController:
    """The facade the router dispatches through: AIMD admission with
    priority classes, deadline-aware shedding, honest Retry-After, and
    the brownout ladder.  One instance per Router."""

    def __init__(self, limiter=None, ladder=None, drain_window_s=30.0,
                 brownout_max_tokens=32, clock=None):
        self.clock = clock or time.monotonic
        self.limiter = limiter or AIMDLimiter(clock=self.clock)
        self.ladder = ladder or BrownoutLadder(clock=self.clock)
        self.drain = DrainRate(window_s=drain_window_s, clock=self.clock)
        self.brownout_max_tokens = int(brownout_max_tokens)
        self._lock = threading.Lock()
        self.shed_total = {p: 0 for p in PRIORITY_CLASSES}
        self.shed_reasons = {"limit": 0, "deadline": 0, "brownout": 0}
        self.admitted_total = {p: 0 for p in PRIORITY_CLASSES}
        self.hedges_suppressed_total = 0
        self.token_caps_applied_total = 0

    # ------------------------------------------------------------ admit

    @staticmethod
    def parse_priority(value):
        """Normalize a request's priority label; unknown/absent labels
        map to the default class (never a 400 — priority is advisory)."""
        if isinstance(value, str) and value.lower() in PRIORITY_CLASSES:
            return value.lower()
        return DEFAULT_PRIORITY

    def retry_after_s(self):
        """Honest backoff hint: the excess in-flight work over the
        observed drain rate — 'come back when the queue you would have
        joined has actually drained', clamped to [1, 30]."""
        rate = self.drain.rate()
        snap = self.limiter.snapshot()
        excess = max(1.0, snap["inflight"] - snap["limit"] + 1.0)
        if rate <= 0:
            return 1
        return max(1, min(30, int(math.ceil(excess / rate))))

    def admit(self, priority=DEFAULT_PRIORITY, deadline_ms=None):
        """Take a dispatch permit or raise ``ShedError`` (HTTP 429).
        Shedding order under pressure: brownout rung 3 sheds all
        background traffic; then the class slices of the AIMD limit
        (background saturates first); then the deadline check sheds a
        request that could not survive the estimated wait anyway."""
        priority = self.parse_priority(priority)
        if priority == "background" and self.ladder.shed_background():
            self._count_shed(priority, "brownout")
            raise ShedError(
                "brownout rung 3: background traffic is shed",
                self.retry_after_s(), "brownout", priority)
        if deadline_ms is not None:
            rate = self.drain.rate()
            if rate > 0:
                # the fleet serves up to `limit` requests in PARALLEL:
                # only the queue beyond the limit is wait this request
                # would actually eat (at healthy concurrency the excess
                # is 0 and no deadline is ever shed)
                snap = self.limiter.snapshot()
                excess = max(0.0, snap["inflight"] - snap["limit"])
                est_wait_s = excess / rate
                if est_wait_s > float(deadline_ms) / 1e3:
                    self._count_shed(priority, "deadline")
                    raise ShedError(
                        f"estimated queue wait {est_wait_s:.1f}s exceeds "
                        f"the request deadline {deadline_ms}ms",
                        self.retry_after_s(), "deadline", priority)
        if not self.limiter.try_acquire(priority):
            self._count_shed(priority, "limit")
            raise ShedError(
                f"concurrency limit reached for class {priority!r} "
                f"(AIMD limit {self.limiter.snapshot()['limit']})",
                self.retry_after_s(), "limit", priority)
        with self._lock:
            self.admitted_total[priority] += 1
        return priority

    def release(self, overloaded=False, completed=True):
        """Return the permit taken by a successful admit().
        overloaded: the upstream signalled congestion (replica 429/503)
        — drives the multiplicative decrease.  completed: the request
        genuinely finished (feeds the drain-rate estimator AND gates the
        additive increase — failures move the limit nowhere)."""
        self.limiter.release(overloaded=overloaded, success=completed)
        if completed:
            self.drain.observe()

    def _count_shed(self, priority, reason):
        with self._lock:
            self.shed_total[priority] += 1
            self.shed_reasons[reason] += 1

    # ------------------------------------------------------- brownout taps

    def observe_slo(self, ttft_p99_s, now=None):
        """Feed one recent-window TTFT p99 reading into the ladder
        (called from the router's poll loop)."""
        return self.ladder.observe(ttft_p99_s, now=now)

    def hedging_allowed(self):
        if self.ladder.hedging_allowed():
            return True
        with self._lock:
            self.hedges_suppressed_total += 1
        return False

    def cap_max_tokens(self, requested):
        """Brownout rung 2: cap a request's effective max_tokens.
        Returns the capped value (and counts the cap when it bit)."""
        if not self.ladder.capping_tokens():
            return requested
        capped = min(int(requested), self.brownout_max_tokens)
        if capped < int(requested):
            with self._lock:
                self.token_caps_applied_total += 1
        return capped

    # ------------------------------------------------------------ render

    def snapshot(self):
        with self._lock:
            out = {
                "shed_total": dict(self.shed_total),
                "shed_reasons": dict(self.shed_reasons),
                "admitted_total": dict(self.admitted_total),
                "hedges_suppressed_total": self.hedges_suppressed_total,
                "token_caps_applied_total": self.token_caps_applied_total,
            }
        out["limiter"] = self.limiter.snapshot()
        out["brownout"] = self.ladder.snapshot()
        out["drain_rate_per_s"] = round(self.drain.rate(), 3)
        return out

    def render_lines(self, name):
        """Prometheus text lines (appended to the router's /metrics)."""
        s = self.snapshot()
        lines = [
            f"# HELP {name}_overload_limit current AIMD concurrency limit",
            f"# TYPE {name}_overload_limit gauge",
            f"{name}_overload_limit {s['limiter']['limit']}",
            f"# HELP {name}_overload_inflight admitted in-flight requests",
            f"# TYPE {name}_overload_inflight gauge",
            f"{name}_overload_inflight {s['limiter']['inflight']}",
            f"# HELP {name}_overload_decreases_total multiplicative "
            "limit decreases (congestion events)",
            f"# TYPE {name}_overload_decreases_total counter",
            f"{name}_overload_decreases_total "
            f"{s['limiter']['decreases_total']}",
            f"# HELP {name}_overload_shed_total requests shed 429 by the "
            "overload controller, by priority class",
            f"# TYPE {name}_overload_shed_total counter",
        ]
        for p in PRIORITY_CLASSES:
            lines.append(f'{name}_overload_shed_total{{priority="{p}"}} '
                         f"{s['shed_total'][p]}")
        lines += [
            f"# HELP {name}_overload_shed_reason_total sheds by cause",
            f"# TYPE {name}_overload_shed_reason_total counter",
        ]
        for r in sorted(s["shed_reasons"]):
            lines.append(f'{name}_overload_shed_reason_total'
                         f'{{reason="{r}"}} {s["shed_reasons"][r]}')
        lines += [
            f"# HELP {name}_overload_admitted_total admitted dispatches, "
            "by priority class",
            f"# TYPE {name}_overload_admitted_total counter",
        ]
        for p in PRIORITY_CLASSES:
            lines.append(
                f'{name}_overload_admitted_total{{priority="{p}"}} '
                f"{s['admitted_total'][p]}")
        lines += [
            f"# HELP {name}_brownout_rung current brownout ladder rung "
            "(0 healthy; 1 hedge_off, 2 token_cap, 3 shed_background)",
            f"# TYPE {name}_brownout_rung gauge",
            f"{name}_brownout_rung {s['brownout']['rung']}",
            f"# HELP {name}_brownout_entries_total rung entries, by rung",
            f"# TYPE {name}_brownout_entries_total counter",
        ]
        for r in BROWNOUT_RUNGS:
            lines.append(f'{name}_brownout_entries_total{{rung="{r}"}} '
                         f"{s['brownout']['entries'][r]}")
        lines += [
            f"# HELP {name}_brownout_exits_total rung exits, by rung",
            f"# TYPE {name}_brownout_exits_total counter",
        ]
        for r in BROWNOUT_RUNGS:
            lines.append(f'{name}_brownout_exits_total{{rung="{r}"}} '
                         f"{s['brownout']['exits'][r]}")
        lines += [
            f"# HELP {name}_overload_hedges_suppressed_total hedges "
            "suppressed by brownout rung >= 1",
            f"# TYPE {name}_overload_hedges_suppressed_total counter",
            f"{name}_overload_hedges_suppressed_total "
            f"{s['hedges_suppressed_total']}",
            f"# HELP {name}_overload_token_caps_total per-request "
            "max_tokens caps applied by brownout rung >= 2",
            f"# TYPE {name}_overload_token_caps_total counter",
            f"{name}_overload_token_caps_total "
            f"{s['token_caps_applied_total']}",
            f"# HELP {name}_overload_drain_rate observed completions "
            "per second (the Retry-After denominator)",
            f"# TYPE {name}_overload_drain_rate gauge",
            f"{name}_overload_drain_rate {s['drain_rate_per_s']}",
        ]
        return lines
