"""Trace-driven autoscaler: the control loop that sizes the replica
fleet to its SLO (``paddle_tpu/serving/autoscaler.py``).

Everything below it exists: the ``ReplicaSupervisor`` (fleet.py) can
spawn a replica to readiness and drain one out with zero failed
requests; the router's metrics say where the latency is.  This is the
loop that ACTS on that evidence — a fleet size of ``--replicas N`` is
wrong the moment load changes: SLOs held by control law, not by
provisioning.

The law is deliberately boring (target tracking with hysteresis — the
thing that actually works in production autoscalers):

* SIGNAL — each poll reads the router's live surface: recent-window
  TTFT p99 (``RouterMetrics.slo_p99_recent_s``), per-replica readiness/
  queue depth/in-flight (``Router.replica_states``), breaker states.
  No new instrumentation; the router's surface IS the sensor.
* LAW — a dead band around ``target_ttft_ms``: p99 above
  ``target*(1+hysteresis)`` for ``breach_polls`` consecutive polls →
  scale OUT; p99 below ``target*(1-hysteresis)`` with an empty queue
  for ``slack_polls`` polls → scale IN.  Per-direction cooldowns gate
  actuation (out reacts in seconds, in waits a minute), and min/max
  bounds are hard.
* ACTUATION — scale-out is ``supervisor.add_replica()`` then
  spawn-TO-READINESS: the new replica counts toward capacity only once
  it answers /readyz; one that never does is removed and the attempt
  retried with seeded exponential backoff (the ``fleet.spawn`` and
  ``autoscaler.scale`` fault points make this a replayable chaos
  case).  Scale-in drains the least-loaded replica — and NEVER one
  holding active streams while an idle one exists — through the same
  rolling ``drain()`` that loses zero requests.
* EVIDENCE — every decision is journaled (a bounded ring of dicts that
  replays bit-for-bit given the same signals, seed, and clock), traced
  (``autoscaler.decision`` / ``autoscaler.scale`` events, obs/trace.py)
  and counted (``autoscaler_*`` lines appended to the router's
  /metrics).

The loop takes an injectable monotonic ``clock`` and a seeded rng for
poll jitter + retry backoff, so a test drives it tick-by-tick on a
simulated clock and the full decision log is deterministic.

CLI (``python -m paddle_tpu_torch.serving.autoscaler``):
  --min-replicas/--max-replicas --target-ttft-ms ...   run a managed
      fleet + router + autoscaler (the production shape)
  --smoke   self-test: 1 replica + a seeded load spike → scale-out to 2
      and p99 TTFT back under target, spike ends → rolling scale-in,
      ZERO failed requests; ONE JSON line, exit code.
  ``--replica-arg`` goes to every replica (``--device cpu`` runs them,
  and the smoke's in-process reference, on the CPU).
"""

import argparse
import json
import math
import random
import signal
import sys
import threading
import time

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.logging import logger

DECISIONS = ("out", "in", "hold")


class Autoscaler:
    """Target-tracking control loop over a ``ReplicaSupervisor`` +
    ``Router`` pair.  All tuning knobs default from utils/flags.py
    (``autoscaler_*``)."""

    def __init__(self, supervisor, router, poll_interval_s=None,
                 target_ttft_ms=None, hysteresis=None, breach_polls=None,
                 slack_polls=None, cooldown_out_s=None, cooldown_in_s=None,
                 min_replicas=None, max_replicas=None, window_s=None,
                 seed=None, ready_timeout_s=240.0, drain_timeout_s=60.0,
                 retry_base_s=0.5, retry_max_s=10.0, retry_max_attempts=8,
                 journal_cap=4096, clock=None, name="autoscaler"):
        def _f(v, flag):
            return getattr(FLAGS, flag) if v is None else v

        self.supervisor = supervisor
        self.router = router
        self.poll_interval_s = float(_f(poll_interval_s,
                                        "autoscaler_poll_interval_s"))
        self.target_s = float(_f(target_ttft_ms,
                                 "autoscaler_target_ttft_ms")) / 1e3
        self.hysteresis = float(_f(hysteresis, "autoscaler_hysteresis"))
        self.breach_polls = int(_f(breach_polls, "autoscaler_breach_polls"))
        self.slack_polls = int(_f(slack_polls, "autoscaler_slack_polls"))
        self.cooldown_out_s = float(_f(cooldown_out_s,
                                       "autoscaler_cooldown_out_s"))
        self.cooldown_in_s = float(_f(cooldown_in_s,
                                      "autoscaler_cooldown_in_s"))
        self.min_replicas = int(_f(min_replicas,
                                   "autoscaler_min_replicas"))
        self.max_replicas = int(_f(max_replicas,
                                   "autoscaler_max_replicas"))
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        self.window_s = float(_f(window_s, "autoscaler_window_s"))
        self.ready_timeout_s = float(ready_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.retry_base_s = float(retry_base_s)
        self.retry_max_s = float(retry_max_s)
        self.retry_max_attempts = int(retry_max_attempts)
        self.name = name
        self.clock = clock or time.monotonic
        # ONE seeded stream drives poll jitter and retry backoff, in
        # tick order — the reason the whole decision log replays
        self._rng = random.Random(int(_f(seed, "autoscaler_seed")))
        self._lock = threading.Lock()
        # control state.  Cooldowns anchor on the LAST SCALE OF ANY
        # DIRECTION, gated by the acting direction's own cooldown — the
        # flap-damping semantics the acceptance bar wants ("the replica
        # count changes at most once per cooldown window"): a scale-in
        # cannot fire within cooldown_in_s of the scale-out it would
        # undo, and vice versa.
        self._breach_streak = 0
        self._slack_streak = 0
        self._last_change = -math.inf
        self._retry = None              # {"direction","at","k"} pending
        self._tick = 0
        # evidence
        self.journal = []               # bounded decision ring
        self.journal_cap = int(journal_cap)
        self.decisions_total = {d: 0 for d in DECISIONS}
        self.scales_total = {"out": 0, "in": 0}
        self.scale_failures_total = 0
        self.last_signals = {}
        self._closed = threading.Event()
        self._thread = None
        # contribute autoscaler_* lines to the router's /metrics page
        router.extra_render_fns.append(self.render_lines)

    # ------------------------------------------------------------ signals

    def collect(self):
        """One reading of the router's surface: fleet-wide recent-window
        TTFT p99 plus the router's live per-replica view.  Pure read —
        collect() never mutates control state."""
        states = self.router.replica_states()
        ready = sorted(rid for rid, st in states.items()
                       if st["ready"] and st["breaker"] != "open")
        loads = {rid: st["queue_depth"] + st["inflight"]
                 for rid, st in states.items()}
        p99_s = self.router.metrics.slo_p99_recent_s(self.window_s)
        return {
            # None = no completion landed inside the window (idle fleet
            # OR total stall — decide() disambiguates via queue/inflight)
            "ttft_p99_ms": round(p99_s * 1e3, 3)
            if p99_s is not None else None,
            "replicas": len(self.supervisor.replicas),
            "ready_replicas": len(ready),
            "ready": ready,
            "loads": loads,
            "queue_depth": sum(st["queue_depth"]
                               for st in states.values()),
            "inflight": sum(st["inflight"] for st in states.values()),
            "breakers_open": sorted(rid for rid, st in states.items()
                                    if st["breaker"] == "open"),
        }

    # ------------------------------------------------------------ the law

    def decide(self, sig, now):
        """The pure control law: (decision, reason).  Deterministic in
        (signals, control state, now) — no clock reads, no randomness —
        so a journal replays bit-for-bit."""
        n_total = sig["replicas"]
        p99_s = (sig["ttft_p99_ms"] / 1e3
                 if sig["ttft_p99_ms"] is not None else None)
        high = self.target_s * (1.0 + self.hysteresis)
        low = self.target_s * (1.0 - self.hysteresis)
        if self._retry is not None:
            # a failed actuation owns the loop — but it must not outlive
            # the conditions that justified it: a retry is ABANDONED
            # when the bounds no longer allow the direction, when the
            # signal has swung to the opposite band (the spike ended
            # while the spawn was failing), or after retry_max_attempts
            # (the law then re-decides from fresh streaks)
            d = self._retry["direction"]
            abandon = (
                self._retry["k"] > self.retry_max_attempts
                or (d == "out" and (n_total >= self.max_replicas
                                    or (p99_s is not None
                                        and p99_s < low)))
                or (d == "in" and (n_total <= self.min_replicas
                                   or (p99_s is not None
                                       and p99_s > high))))
            if abandon:
                self._retry = None
                self._breach_streak = 0     # demand fresh evidence
                self._slack_streak = 0
            elif now >= self._retry["at"]:
                return d, (f"retry #{self._retry['k']} after failed "
                           f"scale-{d}")
            else:
                return "hold", "awaiting actuation retry backoff"
        if p99_s is None:
            # NO SIGNAL in the window.  A truly idle fleet (no queued or
            # in-flight work) is slack — shrink it; anything else could
            # be a total stall where nothing completes, which must never
            # read as 'healthy 0ms'
            breach = False
            slack = sig["queue_depth"] == 0 and sig["inflight"] == 0
        else:
            breach = p99_s > high
            # slack does NOT require zero in-flight work: an over-
            # provisioned fleet that is merely busy must still shrink —
            # the victim choice (idle-preferred) and the graceful drain
            # make that safe
            slack = p99_s < low and sig["queue_depth"] == 0
        if breach:
            self._breach_streak += 1
            self._slack_streak = 0
        elif slack:
            self._slack_streak += 1
            self._breach_streak = 0
        else:
            self._breach_streak = 0
            self._slack_streak = 0
        if (self._breach_streak >= self.breach_polls
                and n_total < self.max_replicas
                and now - self._last_change >= self.cooldown_out_s):
            return "out", (f"ttft_p99 {sig['ttft_p99_ms']:.0f}ms > "
                           f"{high * 1e3:.0f}ms for "
                           f"{self._breach_streak} polls")
        if (self._slack_streak >= self.slack_polls
                and n_total > self.min_replicas
                and now - self._last_change >= self.cooldown_in_s):
            p99_txt = (f"{sig['ttft_p99_ms']:.0f}ms" if sig["ttft_p99_ms"]
                       is not None else "no-signal (fleet idle)")
            return "in", (f"ttft_p99 {p99_txt} < {low * 1e3:.0f}ms for "
                          f"{self._slack_streak} polls")
        # blocked decisions journal WHY they held — the replayable
        # evidence must distinguish "healthy" from "breaching but
        # damped" during an incident
        if self._breach_streak >= self.breach_polls:
            if n_total >= self.max_replicas:
                return "hold", "breach but at max_replicas"
            return "hold", (f"breach ({self._breach_streak} polls) "
                            "cooling down after the last scale")
        if self._slack_streak >= self.slack_polls:
            if n_total <= self.min_replicas:
                return "hold", "slack but at min_replicas"
            return "hold", (f"slack ({self._slack_streak} polls) "
                            "cooling down after the last scale")
        return "hold", "inside the dead band"

    # --------------------------------------------------------- actuation

    def _pick_victim(self, sig):
        """Scale-in victim, in order of preference: (1) a replica that
        is NOT serving (dead, backoff, storm-tripped — removing broken
        capacity is the cheapest scale-in, and draining the only
        HEALTHY replica while a corpse stays counted would be an
        outage); (2) an IDLE ready replica — one holding active
        generation slots is never drained while an idle one exists (its
        streams would ride the failover path for no reason); (3) the
        least-loaded ready replica (the graceful drain finishes its
        streams).  Only replicas the supervisor still owns are
        candidates: the router's view lags the fleet by up to a poll
        interval."""
        owned = set(self.supervisor.replicas)
        if not owned:
            return None
        ready = [r for r in sig["ready"] if r in owned]
        unready = sorted(owned - set(ready))
        if unready:
            return unready[0]
        cands = ready or sorted(owned)
        idle = [r for r in cands if sig["loads"].get(r, 0) == 0]
        pool = idle or cands
        return min(pool, key=lambda r: (sig["loads"].get(r, 0), r))

    def _schedule_retry(self, direction, now):
        k = (self._retry["k"] + 1) if self._retry is not None else 1
        delay = min(self.retry_base_s * (2 ** (k - 1)), self.retry_max_s)
        delay *= 0.5 + 0.5 * self._rng.random()     # seeded jitter
        self._retry = {"direction": direction, "at": now + delay, "k": k}
        self.scale_failures_total += 1
        return delay

    def actuate(self, direction, sig, now):
        """Execute one scale decision.  Returns an evidence dict for the
        journal.  Failures (the ``autoscaler.scale`` / ``fleet.spawn``
        fault points, a replica that never reaches readiness) schedule a
        seeded-backoff retry and leave capacity accounting untouched —
        an unready replica is REMOVED, never counted."""
        with obstrace.span("autoscaler.scale", root=False,
                           direction=direction):
            try:
                faults.hit("autoscaler.scale")
                if direction == "out":
                    rid = self.supervisor.add_replica()
                    if not self.supervisor.wait_ready(
                            timeout=self.ready_timeout_s, rids=(rid,)):
                        # spawned but never ready: it must not linger as
                        # phantom capacity
                        self.supervisor.remove_replica(
                            rid, drain_timeout=5.0)
                        raise RuntimeError(
                            f"{rid} not ready within "
                            f"{self.ready_timeout_s:.0f}s")
                    evidence = {"replica": rid, "ok": True}
                else:
                    rid = self._pick_victim(sig)
                    if rid is None:
                        raise RuntimeError("no drainable replica")
                    self.supervisor.remove_replica(
                        rid, drain_timeout=self.drain_timeout_s)
                    evidence = {"replica": rid, "ok": True}
            except Exception as e:    # noqa: BLE001 — actuation chaos
                delay = self._schedule_retry(direction, now)
                logger.warning(
                    "%s: scale-%s failed (%s: %s); retry #%d in %.2fs",
                    self.name, direction, type(e).__name__, e,
                    self._retry["k"], delay)
                return {"ok": False,
                        "error": f"{type(e).__name__}: {e}"[:200],
                        "retry_in_s": round(delay, 4)}
        self._retry = None
        self.scales_total[direction] += 1
        self._last_change = now
        self._breach_streak = 0     # fresh evidence at the new size
        self._slack_streak = 0
        logger.info("%s: scaled %s (%s); fleet now %d replica(s)",
                    self.name, direction.upper(), evidence["replica"],
                    len(self.supervisor.replicas))
        return evidence

    # ------------------------------------------------------------- loop

    def tick(self, now=None):
        """One control iteration: collect → decide → actuate → journal.
        Tests call this directly with a simulated ``now``; the
        background loop calls it on the jittered poll cadence."""
        with self._lock:
            now = self.clock() if now is None else now
            sig = self.collect()
            self.last_signals = sig
            decision, reason = self.decide(sig, now)
            entry = {"tick": self._tick, "t": round(now, 6),
                     "decision": decision, "reason": reason,
                     "signals": sig}
            self._tick += 1
            self.decisions_total[decision] += 1
            if decision in ("out", "in"):
                entry["actuation"] = self.actuate(decision, sig, now)
            self.journal.append(entry)
            if len(self.journal) > self.journal_cap:
                del self.journal[:len(self.journal) - self.journal_cap]
            obstrace.instant("autoscaler.decision", decision=decision,
                             reason=reason, ttft_p99_ms=sig["ttft_p99_ms"],
                             replicas=sig["replicas"])
            return entry

    def _loop(self):
        while not self._closed.is_set():
            try:
                self.tick()
            except Exception as e:    # noqa: BLE001 — the control loop
                # must outlive any one bad poll (a dying replica can make
                # collect() race a view teardown)
                logger.warning("%s: tick failed: %s: %s", self.name,
                               type(e).__name__, e)
            # seeded jitter de-synchronizes fleets of autoscalers without
            # giving up replayability (the rng is consumed in tick order)
            self._closed.wait(self.poll_interval_s
                              * (0.9 + 0.2 * self._rng.random()))

    def start(self):
        """Run the loop on a daemon thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._closed.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=self.name)
            self._thread.start()
        return self

    def close(self):
        self._closed.set()
        if self._thread is not None:
            self._thread.join(5)
        # stop contributing to the router's /metrics: a replaced
        # autoscaler must not leave duplicate/stale autoscaler_* series
        # (and must not keep this instance reachable forever)
        try:
            self.router.extra_render_fns.remove(self.render_lines)
        except ValueError:
            pass                    # already removed (idempotent close)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- evidence

    def snapshot(self):
        return {
            "replicas": len(self.supervisor.replicas),
            "decisions_total": dict(self.decisions_total),
            "scales_total": dict(self.scales_total),
            "scale_failures_total": self.scale_failures_total,
            "last_signals": dict(self.last_signals),
            "journal_len": len(self.journal),
        }

    def journal_lines(self):
        """The decision log as JSON lines (replayable evidence)."""
        return [json.dumps(e, sort_keys=True) for e in self.journal]

    def render_lines(self):
        """autoscaler_* Prometheus lines for the router's /metrics."""
        n = self.router.metrics.name
        s = self.snapshot()
        lines = [
            f"# HELP {n}_autoscaler_replicas supervised replicas",
            f"# TYPE {n}_autoscaler_replicas gauge",
            f"{n}_autoscaler_replicas {s['replicas']}",
            f"# HELP {n}_autoscaler_decisions_total control decisions, "
            "by direction",
            f"# TYPE {n}_autoscaler_decisions_total counter",
        ]
        for d in DECISIONS:
            lines.append(f'{n}_autoscaler_decisions_total'
                         f'{{direction="{d}"}} '
                         f"{s['decisions_total'][d]}")
        lines += [
            f"# HELP {n}_autoscaler_scales_total completed scale "
            "actuations, by direction",
            f"# TYPE {n}_autoscaler_scales_total counter",
        ]
        for d in ("out", "in"):
            lines.append(f'{n}_autoscaler_scales_total'
                         f'{{direction="{d}"}} {s["scales_total"][d]}')
        lines += [
            f"# HELP {n}_autoscaler_scale_failures_total failed "
            "actuations (retried with seeded backoff)",
            f"# TYPE {n}_autoscaler_scale_failures_total counter",
            f"{n}_autoscaler_scale_failures_total "
            f"{s['scale_failures_total']}",
            f"# HELP {n}_autoscaler_ttft_p99_ms last polled recent-"
            "window TTFT p99 (the tracked SLO signal; NaN = no sample "
            "completed inside the window)",
            f"# TYPE {n}_autoscaler_ttft_p99_ms gauge",
            f"{n}_autoscaler_ttft_p99_ms "
            f"{s['last_signals'].get('ttft_p99_ms') if s['last_signals'].get('ttft_p99_ms') is not None else 'NaN'}",
        ]
        return lines


# ------------------------------------------------------------------ smoke


def _smoke(replica_args=()):
    """Autoscale self-test: ONE tiny demo replica behind the router +
    autoscaler (min 1, max 2); a seeded load spike of concurrent paced
    streams breaches the TTFT target → the loop scales out to 2 and
    spawn-to-readiness completes; with both replicas serving, the
    post-scale drive's p99 TTFT sits back under target; the spike ends →
    sustained slack scales back in through the rolling drain.  EVERY
    request must either complete bit for bit an in-process engine built
    from the replicas' seed or be shed 429 with a Retry-After header —
    zero failed requests.  ONE JSON line; returns the exit code."""
    import http.client
    import numpy as _np
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
    from paddle_tpu_torch.serving.router import Router, demo_reference

    errs = []
    out = {"metric": "autoscale smoke (trace-driven control loop: spike "
                     "-> scale-out -> recover -> scale-in)",
           "vs_baseline": None}
    vocab, max_len, n_tokens, slots = 256, 64, 12, 2
    n_spike_clients = 8
    target_ms = 600.0
    # the demo LM replica at 2 slots; the injected decode-step hang
    # paces tokens (~30ms each, ~0.4s per stream), so the 8-client
    # spike queues 3-4 streams deep per slot and the recent-window TTFT
    # p99 lands well above target*(1+hysteresis) while a 2-client
    # steady drive on the scaled fleet stays far below target
    base_args = ["--gen-slots", str(slots), "--gen-max-len", str(max_len),
                 "--gen-prefill-buckets", "8,16",
                 "--gen-max-tokens", str(n_tokens), *replica_args]
    extra = base_args + [
        "--fault-spec",
        "serving.decode_step:every=1,action=hang,hang_s=0.03"]
    sup = ReplicaSupervisor(n_replicas=1, extra_args=extra,
                            backoff_base_s=0.3, seed=0,
                            name="autoscale_smoke")
    router = Router(supervisor=sup, poll_interval_s=0.1,
                    retry_budget=3, name="router_autoscale")
    scaler = Autoscaler(
        sup, router, poll_interval_s=0.25, target_ttft_ms=target_ms,
        hysteresis=0.2, breach_polls=2, slack_polls=10,
        cooldown_out_s=2.0, cooldown_in_s=4.0, min_replicas=1,
        max_replicas=2, window_s=6.0, seed=0, ready_timeout_s=240.0,
        name="autoscaler_smoke")
    httpd = None
    completed, shed, failed = [], [], []
    lock = threading.Lock()

    rng = _np.random.RandomState(0)
    prompts = [rng.randint(1, vocab, 3 + 2 * (i % 6)).astype(_np.int64)
               for i in range(n_spike_clients)]

    def one_stream(i, port):
        """One streaming request; records completion/shed/failure and
        returns the TTFT ms (None unless completed)."""
        t0 = time.perf_counter()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            conn.request("POST", "/v1/generate",
                         json.dumps({"prompt": prompts[i].tolist(),
                                     "max_tokens": n_tokens,
                                     "stream": True}).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status == 429:
                ra = resp.getheader("Retry-After")
                resp.read()
                conn.close()
                with lock:
                    shed.append({"retry_after": ra})
                if ra is None:
                    errs.append("shed response missing Retry-After")
                return None
            toks, ttft_ms, done = [], None, None
            while True:
                line = resp.readline()
                if not line:
                    break
                rec = json.loads(line)
                if "token" in rec:
                    if not toks:
                        ttft_ms = (time.perf_counter() - t0) * 1e3
                    toks.append(rec["token"])
                if rec.get("done"):
                    done = rec
                    break
            conn.close()
            if done is None or toks != oracle[i]:
                with lock:
                    failed.append({"i": i, "toks": toks[:4]})
                return None
            with lock:
                completed.append(ttft_ms)
            return ttft_ms
        except Exception as e:      # noqa: BLE001
            with lock:
                failed.append({"i": i, "err": f"{type(e).__name__}: {e}"})
            return None

    try:
        oracle, _eng = demo_reference(base_args, prompts, n_tokens)
        sup.start()
        if not sup.wait_ready(timeout=240):
            raise RuntimeError("seed replica never became ready")
        httpd = router.start(port=0)
        deadline = time.monotonic() + 30
        while not router.ready() and time.monotonic() < deadline:
            time.sleep(0.05)
        scaler.start()
        port = httpd.port

        # ---- SPIKE: n_spike_clients concurrent paced clients loop
        # until the scaler has brought the second replica to readiness
        # (bounded)
        spike_stop = threading.Event()
        spike_ttfts = []

        def spike_client(i):
            while not spike_stop.is_set():
                t = one_stream(i, port)
                if t is not None:
                    with lock:
                        spike_ttfts.append(t)

        threads = [threading.Thread(target=spike_client, args=(i,))
                   for i in range(n_spike_clients)]
        for t in threads:
            t.start()
        spike_deadline = time.monotonic() + 300
        while time.monotonic() < spike_deadline:
            if len(sup.replicas) >= 2 and sup.wait_ready(timeout=0.1):
                break
            time.sleep(0.2)
        scaled_out = len(sup.replicas) >= 2
        spike_stop.set()
        for t in threads:
            t.join(180)
        out["scaled_out"] = bool(scaled_out)
        out["spike_requests"] = len(completed) + len(shed)
        spike_p99 = (sorted(spike_ttfts)[int(0.99 * (len(spike_ttfts)
                                                     - 1))]
                     if spike_ttfts else None)
        out["spike_ttft_p99_ms"] = round(spike_p99, 1) \
            if spike_p99 is not None else None

        # ---- RECOVERED: with 2 replicas serving, a light steady drive
        # must sit back under the target
        steady = []
        for rep in range(3):
            ts = [threading.Thread(
                target=lambda i=i: steady.append(one_stream(i, port)))
                for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
        steady_ok = [t for t in steady if t is not None]
        steady_p99 = (sorted(steady_ok)[int(0.99 * (len(steady_ok) - 1))]
                      if steady_ok else None)
        out["steady_ttft_p99_ms"] = round(steady_p99, 1) \
            if steady_p99 is not None else None
        recovered = steady_p99 is not None and steady_p99 < target_ms

        # ---- SLACK: traffic stops; sustained slack + cooldown scale
        # the fleet back in through the zero-failure rolling drain
        scale_in_deadline = time.monotonic() + 120
        while time.monotonic() < scale_in_deadline:
            if len(sup.replicas) <= 1:
                break
            time.sleep(0.2)
        scaled_in = len(sup.replicas) <= 1

        snap = scaler.snapshot()
        decisions = [e["decision"] for e in scaler.journal]
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            mtext = r.read().decode()
        out.update(
            scaled_in=bool(scaled_in),
            recovered_under_target=bool(recovered),
            completed=len(completed),
            shed=len(shed),
            failed=len(failed),
            decisions_out=snap["scales_total"]["out"],
            decisions_in=snap["scales_total"]["in"],
            scale_failures=snap["scale_failures_total"],
            journal_len=snap["journal_len"],
            metrics_sane=("autoscaler_replicas" in mtext
                          and "autoscaler_scales_total" in mtext
                          and "overload_limit" in mtext),
        )
        checks = [
            scaled_out,
            recovered,
            scaled_in,
            len(failed) == 0 and len(completed) > 0,
            "out" in decisions and "in" in decisions,
            bool(out["metrics_sane"]),
        ]
        if failed:
            errs.append(f"failed requests: {failed[:3]}")
    except Exception as e:      # noqa: BLE001 — a harness failure must
        errs.append(f"smoke: {type(e).__name__}: {e}")
        checks = [False]
    finally:
        try:
            scaler.close()
            router.close()
        finally:
            sup.stop()
    out["value"] = sum(bool(c) for c in checks)
    out["unit"] = f"checks_ok/{len(checks)}"
    if errs:
        out["errors"] = errs[:5]
    print(json.dumps(out), flush=True)
    return 0 if all(checks) else 2


# -------------------------------------------------------------------- CLI


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.autoscaler",
        description="trace-driven autoscaler over the replica fleet")
    ap.add_argument("--replica-arg", action="append", default=[],
                    help="extra argv appended to each managed replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=FLAGS.router_port)
    ap.add_argument("--min-replicas", type=int,
                    default=FLAGS.autoscaler_min_replicas)
    ap.add_argument("--max-replicas", type=int,
                    default=FLAGS.autoscaler_max_replicas)
    ap.add_argument("--target-ttft-ms", type=float,
                    default=FLAGS.autoscaler_target_ttft_ms)
    ap.add_argument("--hysteresis", type=float,
                    default=FLAGS.autoscaler_hysteresis)
    ap.add_argument("--poll-interval-s", type=float,
                    default=FLAGS.autoscaler_poll_interval_s)
    ap.add_argument("--cooldown-out-s", type=float,
                    default=FLAGS.autoscaler_cooldown_out_s)
    ap.add_argument("--cooldown-in-s", type=float,
                    default=FLAGS.autoscaler_cooldown_in_s)
    ap.add_argument("--slo-ttft-ms", type=float,
                    default=FLAGS.overload_slo_ttft_ms,
                    help="router brownout-ladder SLO (0 = ladder off); "
                         "independent of the autoscaler target")
    ap.add_argument("--seed", type=int, default=FLAGS.autoscaler_seed)
    ap.add_argument("--smoke", action="store_true",
                    help="autoscale self-test (1 replica + seeded spike "
                         "-> scale-out -> recover -> scale-in, zero "
                         "failed requests), one JSON line, exit")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.replica_arg)

    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
    from paddle_tpu_torch.serving.router import Router
    sup = ReplicaSupervisor(n_replicas=args.min_replicas,
                            extra_args=args.replica_arg).start()
    router = Router(supervisor=sup, slo_ttft_ms=args.slo_ttft_ms)
    scaler = Autoscaler(sup, router,
                        poll_interval_s=args.poll_interval_s,
                        target_ttft_ms=args.target_ttft_ms,
                        hysteresis=args.hysteresis,
                        cooldown_out_s=args.cooldown_out_s,
                        cooldown_in_s=args.cooldown_in_s,
                        min_replicas=args.min_replicas,
                        max_replicas=args.max_replicas,
                        seed=args.seed).start()
    router.start(args.host, args.port)
    stop = threading.Event()

    def _drain(signum, frame):
        logger.info("SIGTERM: stopping autoscaler + router + fleet")
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    except ValueError:
        pass
    try:
        stop.wait()
    finally:
        scaler.close()
        router.close()
        sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
