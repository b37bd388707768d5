"""Health-checked request router over serving replicas
(``paddle_tpu/serving/router.py``).

The fleet supervisor (serving/fleet.py) keeps N replica processes
alive; this module is the front door that keeps one sick replica from
ever owning a user's tail latency or killing their stream ("The Tail at
Scale" playbook over the resilience substrate, resilience/supervisor.py):

* READINESS-GATED ADMISSION — a background poller probes every
  replica's ``/readyz`` (honoring its ``Retry-After``) and ``/metrics``
  queue depth; dispatch only considers replicas whose last probe said
  ready.  A draining replica (rolling restart) or one with an open
  in-process breaker drops out of rotation the moment it says so.
  When NOTHING looks eligible, dispatch probes the unready replicas
  itself and waits up to ``router_unready_grace_s`` before failing the
  request — the poller's view of a freshly restarted replica lags by up
  to a poll interval, exactly the rolling-restart window.
* LEAST-LOADED DISPATCH — among eligible replicas, pick the smallest
  (polled queue depth + router-side in-flight count).
* OUTLIER EJECTION — per-replica ``CircuitBreaker``
  (resilience/supervisor.py):
  ``router_eject_threshold`` CONSECUTIVE dispatch failures eject the
  replica from rotation; after ``router_eject_cooldown_s`` one
  half-open probe request readmits it on success.
* BOUNDED RETRY — ``/v1/infer`` is idempotent: a transport failure
  retries on a different replica up to ``router_retry_budget`` times.
* HEDGED REQUESTS (optional, ``router_hedge_ms``) — when the primary
  has not answered within the hedge delay (fixed, or p99-derived from
  the router's own recent latency when negative), the same infer fires
  on a second replica and the first answer wins.
* CROSS-REPLICA MID-STREAM FAILOVER — the headline guarantee: when a
  replica dies (kill -9) or is ejected mid-``/v1/generate`` stream, the
  router re-submits ``prompt`` + the tokens already delivered as a
  CONTINUATION (``"replay"``, decode_engine.py) to a healthy replica
  and keeps streaming.  Greedy decode is deterministic, so the client's
  stream finishes BIT-IDENTICAL to an uninterrupted one — the
  in-process slot recovery generalized across process boundaries.  Session affinity (``"session"`` in the body) pins a
  conversation to one replica until failover re-pins it.
* CLIENT-DISCONNECT PROPAGATION — a dropped downstream stream closes
  the upstream replica connection, so the replica's ``abandon()`` slot
  reclamation fires instead of decoding to max_tokens for nobody.
* DISAGGREGATED PREFILL/DECODE (serving/transfer.py) — when the ready set holds both a
  prefill-role and a decode-role replica (``--role`` on server.py,
  advertised via /metrics), a fresh stream runs a 1-token PREFILL leg
  on the prefill pool, then hands off at the first token: the decode
  leg carries chain key + continuation and the decode replica pulls the
  KV blocks over ``/v1/kv/export`` (length-prefixed, trunk-signed spill
  blobs).  Every failure — dead prefill (kill -9), oversized/foreign
  blob, the analytic model preferring recompute — degrades to the plain
  continuation-replay leg, bit-identical by greedy determinism;
  ``kv_handoffs_total{outcome=...}`` counters on the replicas and the
  router prove which path ran.

The ``router.dispatch`` fault point (resilience/faults.py) sits at the
router->replica network boundary: seeded plans inject dispatch errors/
hangs that replay bit-for-bit, like the in-process seven.

CLI (``python -m paddle_tpu_torch.serving.router``):
  --replicas N --replica-arg ...   spawn a managed fleet (fleet.py) of
                                   ``--demo-generate`` replicas, on the
                                   card unless ``--replica-arg=--device
                                   --replica-arg=cpu``
  --backends URL,URL               route over externally-managed replicas
  --smoke                          self-test: 2 tiny replicas, concurrent
                                   generate, kill -9 one mid-stream,
                                   assert completion bit for bit an
                                   in-process engine from the same seed +
                                   /metrics evidence; ONE JSON line
  --smoke-disagg                   disaggregated-serving self-test:
                                   1 prefill + 1 decode replica,
                                   concurrent streams handed off at the
                                   first token over the socket KV
                                   transport, analytic fallback for a
                                   short prompt, kill -9 of the prefill
                                   replica falls back to recompute —
                                   every stream bit-identical; ONE JSON
                                   line
  The smokes' replicas take ``--replica-arg`` too (``--device cpu``
  runs them, and the in-process reference, on the CPU).
"""

import argparse
import http.client
import json
import queue as _queue
import re
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience.supervisor import CircuitBreaker
from paddle_tpu_torch.serving.metrics import BREAKER_STATES, HANDOFF_OUTCOMES
from paddle_tpu_torch.serving.overload import (AIMDLimiter, BrownoutLadder,
                                               OverloadController, ShedError)
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.logging import log_context, logger
from paddle_tpu_torch.utils.stats import Histogram

_QUANTILES = (50, 95, 99)
_QDEPTH_RE = re.compile(r"^\S*_queue_depth (\d+)\s*$", re.MULTILINE)
# disaggregated serving (serving/transfer.py): each replica advertises
# its role on /metrics; the router parses it from the SAME text the
# queue-depth probe already fetched (zero extra requests)
_ROLE_RE = re.compile(r'^\S*_serving_role\{role="(\w+)"\} 1\s*$',
                      re.MULTILINE)

# router-side rejection reasons (part of the /metrics surface);
# shed = the adaptive overload controller refused it (serving/overload.py)
ROUTER_REJECT_REASONS = ("unready", "exhausted", "shed")


class RouterMetrics:
    """Thread-safe router-side counters + latency/TTFT histograms.
    Replica gauges (ready/queue depth/breaker state) are rendered live
    by the Router from its replica views.

    clock: injectable zero-arg monotonic clock threaded into the
    recent-window histograms (default real clock, zero behavior change)
    so the autoscaler's windowed SLO reads — ``slo_p99_recent_s`` — are
    deterministically testable on a simulated clock."""

    def __init__(self, name="paddle_tpu_router", max_samples=100000,
                 clock=None):
        self.name = name
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self.requests_total = {"infer": 0, "generate": 0}
        self.responses_total = 0
        self.rejected = {r: 0 for r in ROUTER_REJECT_REASONS}
        self.dispatch_total = {}          # replica id -> attempts
        self.dispatch_errors_total = {}   # replica id -> transport/5xx
        self.retries_total = 0            # idempotent infer re-dispatches
        self.failovers_total = 0          # generate re-dispatches (any)
        self.midstream_failovers_total = 0  # ... with tokens already out
        self.hedges_total = 0
        self.hedge_wins_total = 0
        self.ejections_total = {}         # replica id -> breaker opens
        self.readmissions_total = {}      # replica id -> half-open closes
        self.client_disconnects_total = 0
        self.tokens_proxied_total = 0
        # disaggregated prefill/decode handoffs as the ROUTER saw them
        # resolve (the replicas keep their own sent/received/fallback
        # counters; serving/transfer.py)
        self.kv_handoffs = {o: 0 for o in HANDOFF_OUTCOMES}
        self.kv_handoff_bytes_total = 0
        self.kv_handoff = Histogram(f"{name}_kv_handoff",
                                    max_samples=max_samples,
                                    clock=self.clock)
        self.latency = Histogram(f"{name}_latency", max_samples=max_samples,
                                 clock=self.clock)
        # fleet-wide time-to-first-token as the ROUTER's clients feel it
        # (streaming: first forwarded token; unary generate: the
        # replica-reported ttft_ms) — the autoscaler's primary SLO signal
        self.ttft = Histogram(f"{name}_ttft", max_samples=max_samples,
                              clock=self.clock)

    def observe_ttft(self, seconds):
        self.ttft.add(seconds)

    def observe_kv_handoff(self, outcome, nbytes=0, seconds=None):
        """One disaggregated KV handoff resolved through this router
        (outcome from serving.metrics.HANDOFF_OUTCOMES; seconds = the
        receive-side fetch+verify+deliver latency when known)."""
        with self._lock:
            self.kv_handoffs[outcome] = \
                self.kv_handoffs.get(outcome, 0) + 1
            self.kv_handoff_bytes_total += int(nbytes)
        if seconds is not None:
            self.kv_handoff.add(seconds)

    def slo_p99_recent_s(self, window_s=None):
        """The control loops' SLO signal: recent-window TTFT p99, falling
        back to request-latency p99 when no generation traffic has
        produced TTFT samples (an infer-only fleet still gets latency-
        based control).  Returns None when NEITHER histogram holds a
        sample in the window — during a total stall nothing completes,
        and an absent signal must never read as 'healthy 0ms' (the
        brownout ladder holds its rung; the autoscaler treats no-signal
        as slack only when the fleet is provably idle)."""
        import numpy as np
        for hist in (self.ttft, self.latency):
            # ONE filtered read per histogram: checking emptiness and
            # computing the percentile from the same snapshot (two
            # separate windowed calls could race the window edge and
            # fabricate a healthy 0.0)
            samples = hist.recent_samples(window_s)
            if samples:
                return float(np.percentile(np.asarray(samples), 99))
        return None

    def _bump(self, table, rid, n=1):
        with self._lock:
            table[rid] = table.get(rid, 0) + n

    def accepted(self, route):
        with self._lock:
            self.requests_total[route] = \
                self.requests_total.get(route, 0) + 1

    def reject(self, reason):
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def observe_response(self, latency_s):
        with self._lock:
            self.responses_total += 1
        self.latency.add(latency_s)

    def count(self, field, n=1):
        with self._lock:
            setattr(self, field, getattr(self, field) + int(n))

    def snapshot(self):
        lat = self.latency.percentiles(_QUANTILES)
        with self._lock:
            out = {
                "requests_total": dict(self.requests_total),
                "responses_total": self.responses_total,
                "rejected": dict(self.rejected),
                "dispatch_total": dict(self.dispatch_total),
                "dispatch_errors_total": dict(self.dispatch_errors_total),
                "retries_total": self.retries_total,
                "failovers_total": self.failovers_total,
                "midstream_failovers_total": self.midstream_failovers_total,
                "hedges_total": self.hedges_total,
                "hedge_wins_total": self.hedge_wins_total,
                "ejections_total": dict(self.ejections_total),
                "readmissions_total": dict(self.readmissions_total),
                "client_disconnects_total": self.client_disconnects_total,
                "tokens_proxied_total": self.tokens_proxied_total,
                "kv_handoffs_total": dict(self.kv_handoffs),
                "kv_handoff_bytes_total": self.kv_handoff_bytes_total,
            }
        out["faults_fired"] = faults.fired_counts()
        out["kv_handoff_ms"] = {f"p{q}": round(v * 1e3, 3)
                                for q, v in self.kv_handoff.percentiles(
                                    _QUANTILES).items()}
        out["latency_ms"] = {f"p{q}": round(v * 1e3, 3)
                             for q, v in lat.items()}
        out["ttft_ms"] = {f"p{q}": round(v * 1e3, 3)
                          for q, v in self.ttft.percentiles(
                              _QUANTILES).items()}
        return out


class _ReplicaView:
    """The router's live view of one replica: last-polled readiness +
    load, and its outlier-ejection breaker.  A replica that restarts at
    a new URL gets a FRESH view (fresh breaker — a new process has no
    failure history)."""

    def __init__(self, rid, base_url, eject_threshold, eject_cooldown_s,
                 clock=None):
        self.rid = rid
        self.base_url = base_url.rstrip("/")
        u = urlsplit(self.base_url)
        self.host, self.port = u.hostname, u.port
        self.breaker = CircuitBreaker(eject_threshold, eject_cooldown_s,
                                      clock=clock)
        self.ready = False
        self.not_before = 0.0         # honored Retry-After (monotonic)
        self.queue_depth = 0
        self.inflight = 0
        self.role = "mixed"           # serving_role{role=...} from the
        #                               probe's /metrics read (prefill|
        #                               decode|mixed; transfer.py)


class Router:
    """Dispatch ``/v1/infer`` and ``/v1/generate`` across replicas.

    replicas: static list of base URLs, OR supervisor: a
    ``ReplicaSupervisor`` whose ``endpoints()`` is re-read every poll
    (restarted replicas appear at their new ports automatically).
    Tuning knobs default from utils/flags.py (``router_*``).
    """

    def __init__(self, replicas=None, supervisor=None,
                 poll_interval_s=None, unready_grace_s=None,
                 eject_threshold=None,
                 eject_cooldown_s=None, retry_budget=None, hedge_ms=None,
                 request_timeout_s=300.0, name="router", metrics=None,
                 overload=None, slo_ttft_ms=None, slo_window_s=None,
                 clock=None):
        if (replicas is None) == (supervisor is None):
            raise ValueError("Router needs exactly one of replicas= "
                             "(static URLs) or supervisor= (managed "
                             "fleet)")
        self.supervisor = supervisor
        # injectable monotonic clock: every time comparison the router
        # makes (Retry-After penalties, grace deadlines, SLO windows)
        # reads it, so tests drive the control surfaces on a simulated
        # clock instead of wall-clock sleeps (default: time.monotonic)
        self._clock = clock or time.monotonic
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else FLAGS.router_poll_interval_s)
        self.unready_grace_s = float(
            unready_grace_s if unready_grace_s is not None
            else FLAGS.router_unready_grace_s)
        self.eject_threshold = int(
            eject_threshold if eject_threshold is not None
            else FLAGS.router_eject_threshold)
        self.eject_cooldown_s = float(
            eject_cooldown_s if eject_cooldown_s is not None
            else FLAGS.router_eject_cooldown_s)
        self.retry_budget = int(retry_budget if retry_budget is not None
                                else FLAGS.router_retry_budget)
        self.hedge_ms = float(hedge_ms if hedge_ms is not None
                              else FLAGS.router_hedge_ms)
        self.request_timeout_s = float(request_timeout_s)
        self.name = name
        self.metrics = metrics or RouterMetrics(clock=self._clock)
        # adaptive overload control (serving/overload.py): AIMD
        # concurrency limit + priority shedding ahead of dispatch, and
        # the brownout ladder driven by the poll loop's SLO reads.  The
        # default ladder is DISABLED (overload_slo_ttft_ms = 0) and the
        # default limiter bounds sit far above normal load, so a router
        # constructed without arguments behaves exactly as before.
        self.slo_ttft_ms = float(slo_ttft_ms if slo_ttft_ms is not None
                                 else FLAGS.overload_slo_ttft_ms)
        self.slo_window_s = float(slo_window_s if slo_window_s is not None
                                  else FLAGS.overload_window_s)
        self.overload = overload or OverloadController(
            limiter=AIMDLimiter(
                initial=FLAGS.overload_limit_initial,
                min_limit=FLAGS.overload_limit_min,
                max_limit=FLAGS.overload_limit_max,
                increase=FLAGS.overload_aimd_increase,
                decrease=FLAGS.overload_aimd_decrease,
                clock=self._clock),
            ladder=BrownoutLadder(
                slo_ttft_s=self.slo_ttft_ms / 1e3,
                enter_hold_s=FLAGS.overload_brownout_hold_s,
                exit_hold_s=FLAGS.overload_brownout_exit_s,
                clock=self._clock),
            drain_window_s=self.slo_window_s,
            brownout_max_tokens=FLAGS.overload_brownout_max_tokens,
            clock=self._clock)
        # extra /metrics contributors (the autoscaler appends its
        # autoscaler_* lines here); each is a zero-arg -> [str]
        self.extra_render_fns = [
            lambda: self.overload.render_lines(self.metrics.name)]
        self._lock = threading.Lock()
        self._replicas = {}
        self._affinity = {}           # session key -> replica id
        self._breaker_state = {}      # replica id -> last seen state
        self._breaker_lock = threading.Lock()   # keeps the transition
        #                                         counters exact under
        #                                         poll/dispatch races
        if replicas is not None:
            for i, url in enumerate(replicas):
                self._replicas[f"r{i}"] = _ReplicaView(
                    f"r{i}", url, self.eject_threshold,
                    self.eject_cooldown_s, clock=self._clock)
        self._closed = threading.Event()
        self._httpd = None
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name=f"{self.name}-health")
        self._poller.start()

    # ------------------------------------------------------------ health

    def _sync_replicas(self):
        if self.supervisor is None:
            return
        eps = dict(self.supervisor.endpoints())
        with self._lock:
            for rid, url in eps.items():
                cur = self._replicas.get(rid)
                if cur is None or cur.base_url != url.rstrip("/"):
                    # new or restarted-at-a-new-port replica: fresh view
                    self._replicas[rid] = _ReplicaView(
                        rid, url, self.eject_threshold,
                        self.eject_cooldown_s, clock=self._clock)
            for rid in [r for r in self._replicas if r not in eps]:
                del self._replicas[rid]

    def _probe(self, rep):
        """One readiness + load probe of one replica (poll thread)."""
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(f"{rep.base_url}/readyz",
                                        timeout=5) as r:
                rep.ready = r.status == 200
            # a live 200 clears any stale Retry-After penalty (e.g. a
            # drain's long hint when the port got reused by the restart)
            rep.not_before = 0.0
        except urllib.error.HTTPError as e:
            rep.ready = False
            ra = e.headers.get("Retry-After")
            if ra is not None:
                try:
                    rep.not_before = self._clock() + float(ra)
                except ValueError:
                    pass
            e.close()
            return
        except Exception:   # noqa: BLE001 — unreachable counts unready
            rep.ready = False
            return
        try:
            with urllib.request.urlopen(f"{rep.base_url}/metrics",
                                        timeout=5) as r:
                text = r.read().decode()
            m = _QDEPTH_RE.search(text)
            if m is not None:
                rep.queue_depth = int(m.group(1))
            m = _ROLE_RE.search(text)
            if m is not None:
                rep.role = m.group(1)
        except Exception:   # noqa: BLE001 — depth/role are advisory
            pass

    def _poll_loop(self):
        while not self._closed.is_set():
            self._sync_replicas()
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                self._probe(rep)
            self._track_breakers()
            # one SLO evaluation per poll: the brownout ladder sees the
            # recent-window TTFT p99 on the same cadence the replicas
            # are probed.  Gated on the ROUTER's slo_ttft_ms (not just
            # the ladder's) so tests can drive an enabled ladder by hand
            # on a simulated clock without the poll thread racing it.
            if self.slo_ttft_ms > 0 and self.overload.ladder.enabled:
                p99 = self.metrics.slo_p99_recent_s(self.slo_window_s)
                # an empty window (total stall: nothing completed) is NOT
                # health — hold the current rung rather than walk down
                if p99 is not None:
                    rung = self.overload.observe_slo(p99)
                    if rung != getattr(self, "_last_rung", 0):
                        obstrace.instant("router.brownout", rung=rung)
                        logger.warning("%s: brownout rung -> %d",
                                       self.name, rung)
                        self._last_rung = rung
            self._closed.wait(self.poll_interval_s)

    def _track_breakers(self):
        """Count breaker-state TRANSITIONS into ejection/readmission
        counters (the breaker itself only exposes state).  Serialized:
        a poll-thread/dispatch-thread race must not double-count a
        transition."""
        with self._lock:
            reps = list(self._replicas.values())
        with self._breaker_lock:
            self._track_breakers_locked(reps)

    def _track_breakers_locked(self, reps):
        for rep in reps:
            st = rep.breaker.state
            prev = self._breaker_state.get(rep.rid)
            if st == "open" and prev in (None, "closed", "half_open"):
                self.metrics._bump(self.metrics.ejections_total, rep.rid)
                obstrace.instant("router.ejected", replica=rep.rid)
                logger.warning("%s: replica %s EJECTED (%d consecutive "
                               "dispatch failures); half-open probe in "
                               "%.1fs", self.name, rep.rid,
                               rep.breaker.threshold,
                               rep.breaker.cooldown_s)
            elif st == "closed" and prev in ("open", "half_open"):
                self.metrics._bump(self.metrics.readmissions_total,
                                   rep.rid)
                obstrace.instant("router.readmitted", replica=rep.rid)
                logger.info("%s: replica %s readmitted (probe succeeded)",
                            self.name, rep.rid)
            self._breaker_state[rep.rid] = st

    # ------------------------------------------------------------ picking

    @staticmethod
    def _role_penalty(rep, prefer_role):
        """0 = the preferred role, 1 = a mixed replica (serves both
        phases), 2 = the opposite role — a dead prefill pool degrades to
        ANY replica rather than failing the request."""
        if prefer_role is None or rep.role == prefer_role:
            return 0
        return 1 if rep.role == "mixed" else 2

    def _pick(self, exclude=(), session=None, prefer_role=None):
        """Least-loaded eligible replica, or None.  ``session`` pins a
        conversation to its previous replica while that replica stays
        eligible (re-pinned on failover).  ``prefer_role`` biases toward
        a disaggregated-serving role (prefill for new prompts, decode
        for handed-off streams) WITHOUT excluding anyone — the role sort
        key outranks load, and session affinity outranks both."""
        now = self._clock()
        with self._lock:
            cands = sorted(
                (r for r in self._replicas.values()
                 if r.rid not in exclude and r.ready
                 and now >= r.not_before),
                key=lambda r: (self._role_penalty(r, prefer_role),
                               r.queue_depth + r.inflight, r.rid))
            if session is not None:
                pinned = self._affinity.get(session)
                cands.sort(key=lambda r: 0 if r.rid == pinned else 1)
        for r in cands:
            ok, _ = r.breaker.admit()
            if ok:
                if session is not None:
                    with self._lock:
                        if len(self._affinity) > 100000:
                            self._affinity.clear()    # bounded memory
                        self._affinity[session] = r.rid
                return r
        return None

    def _pick_eligible(self, exclude=(), session=None, prefer_role=None):
        """``_pick`` plus the retry-anywhere fallback: when nothing ELSE
        is eligible, a transient blip is still retryable on a replica
        that already failed this request."""
        rep = self._pick(exclude=exclude, session=session,
                         prefer_role=prefer_role)
        if rep is None and exclude:
            rep = self._pick(session=session, prefer_role=prefer_role)
        return rep

    def _pick_wait(self, exclude=(), session=None, prefer_role=None):
        """``_pick_eligible``, but a miss does not immediately fail the
        request: the poll thread's view of a freshly restarted replica
        lags by up to a full interval (exactly the rolling-restart
        window where the NEXT victim goes down while the previous one
        is back but not yet re-probed), so probe the unready replicas
        synchronously and wait the transient out, bounded by
        ``unready_grace_s``."""
        rep = self._pick_eligible(exclude, session, prefer_role)
        if rep is not None:
            return rep
        deadline = self._clock() + self.unready_grace_s
        while not self._closed.is_set():
            self._sync_replicas()     # a restarted replica may have just
            #                           appeared at a new port
            with self._lock:
                stale = [r for r in self._replicas.values() if not r.ready]
            for r in stale:
                self._probe(r)
            if stale:
                self._track_breakers()
            rep = self._pick_eligible(exclude, session, prefer_role)
            if rep is not None or self._clock() >= deadline:
                return rep
            self._closed.wait(0.05)
        return None

    def disagg_active(self):
        """True when disaggregated prefill/decode orchestration should
        run: handoffs are enabled AND the ready set contains both a
        prefill-role and a decode-role replica.  An all-mixed fleet (the
        default) never pays the extra leg; a half-dead disagg fleet
        degrades to ordinary routing."""
        if not FLAGS.serving_handoff:
            return False
        with self._lock:
            roles = {r.role for r in self._replicas.values() if r.ready}
        return "prefill" in roles and "decode" in roles

    def _retry_after_hint(self):
        """Seconds until routing could plausibly succeed — min over
        replicas of (Retry-After remaining, breaker probe delay, one
        poll interval)."""
        now = self._clock()
        with self._lock:
            reps = list(self._replicas.values())
        if not reps:
            return max(1, int(round(self.poll_interval_s + 0.5)))
        hints = []
        for r in reps:
            h = self.poll_interval_s
            if not r.ready:
                h = max(h, r.not_before - now)
            h = max(h, r.breaker.seconds_until_probe())
            hints.append(h)
        return max(1, int(round(min(hints) + 0.5)))

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, rep, method, path, body=None, timeout=None,
                  stream=False, ctx=None):
        """One upstream exchange against one replica.  The fault point
        sits HERE — the router->replica network boundary: an injected
        error models a failed dispatch, an injected hang a stalled one
        (both drive the same retry/failover paths a real network fault
        would).  stream=True returns (conn, resp) with the connection
        left open; the caller owns closing it.

        Tracing (obs/trace.py): each dispatch is a span (child of the
        router's request root — or of ``ctx``, for hedge threads that
        lose the ambient context), and its span id rides to the replica
        in a ``traceparent`` header, so the replica's ``server.request``
        span parents HERE and one trace_id stitches the whole hop."""
        self.metrics._bump(self.metrics.dispatch_total, rep.rid)
        faults.hit("router.dispatch")
        sp = obstrace.start_span("router.dispatch", ctx=ctx,
                                 replica=rep.rid, path=path)
        conn = http.client.HTTPConnection(
            rep.host, rep.port,
            timeout=timeout if timeout is not None
            else self.request_timeout_s)
        try:
            headers = {"Content-Type": "application/json"} if body else {}
            if sp.trace_id:
                obstrace.inject(headers, ctx=(sp.trace_id, sp.span_id))
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
        except Exception as e:
            sp.end(error=f"{type(e).__name__}: {e}")
            conn.close()
            raise
        sp.end(status=resp.status)
        if stream:
            return conn, resp
        try:
            data = resp.read()
        finally:
            conn.close()
        return resp.status, dict(resp.getheaders()), data

    def _record(self, rep, ok):
        """Per-replica outlier accounting: transport failures (and 5xx
        other than an orderly 503) count toward ejection; any orderly
        answer counts as health."""
        if ok:
            rep.breaker.record_success()
        else:
            self.metrics._bump(self.metrics.dispatch_errors_total, rep.rid)
            rep.breaker.record_failure()
        self._track_breakers()

    def _honor_503(self, rep, headers):
        """An orderly 503 (draining / breaker / warming): take the
        replica out of rotation for its advertised Retry-After without
        charging its ejection breaker."""
        rep.ready = False
        ra = (headers or {}).get("Retry-After")
        try:
            rep.not_before = self._clock() + float(ra)
        except (TypeError, ValueError):
            rep.not_before = self._clock() + self.poll_interval_s
        rep.breaker.release_probe()

    # ------------------------------------------------------------ unary

    def _call(self, rep, path, body, ctx=None):
        """One accounted unary dispatch: returns (status, headers, data);
        raises on transport failure (breaker charged)."""
        with self._lock:
            rep.inflight += 1
        try:
            st, hd, data = self._dispatch(rep, "POST", path, body, ctx=ctx)
        except Exception:
            self._record(rep, ok=False)
            raise
        finally:
            with self._lock:
                rep.inflight -= 1
        self._record(rep, ok=st < 500 or st == 503)
        return st, hd, data

    def _hedge_delay_s(self):
        if self.hedge_ms == 0:
            return None
        if self.hedge_ms > 0:
            return self.hedge_ms / 1e3
        p99 = self.latency_p99_s()
        return p99 if p99 > 0 else 0.05

    def latency_p99_s(self):
        return self.metrics.latency.percentiles((99,)).get(99, 0.0)

    def _hedged_call(self, rep, path, body, exclude):
        """Primary dispatch with an optional hedge: if the primary has
        not answered within the hedge delay, the same (idempotent)
        request fires on a second replica and the first answer wins —
        the tied-request tail-taming move."""
        delay = self._hedge_delay_s()
        if delay is None:
            return self._call(rep, path, body)
        results = _queue.Queue()
        # hedge legs run on fresh threads, which do NOT inherit the
        # handler's context-local span — hand them the parent explicitly
        ctx = obstrace.current()

        def run(r, tag):
            try:
                results.put((tag, self._call(r, path, body, ctx=ctx),
                             None))
            except Exception as e:    # noqa: BLE001 — crosses threads
                results.put((tag, None, e))

        threading.Thread(target=run, args=(rep, "primary"),
                         daemon=True).start()
        try:
            tag, out, exc = results.get(timeout=delay)
        except _queue.Empty:
            rep2 = self._pick(exclude=set(exclude) | {rep.rid})
            if rep2 is None:
                tag, out, exc = results.get()     # nothing to hedge onto
            else:
                self.metrics.count("hedges_total")
                threading.Thread(target=run, args=(rep2, "hedge"),
                                 daemon=True).start()
                tag, out, exc = results.get()
                if exc is not None or out[0] >= 500:
                    # first answer was a failure: the race is still on
                    tag, out, exc = results.get()
        if exc is not None:
            raise exc
        if tag == "hedge":
            self.metrics.count("hedge_wins_total")
        return out

    def route_unary(self, route, path, body, session=None, hedge=False):
        """Dispatch one unary request with bounded cross-replica retry.
        Returns (status, headers, data) for the client.  ``hedge`` only
        for idempotent routes (/v1/infer)."""
        t0 = time.perf_counter()
        self.metrics.accepted(route)
        exclude = set()
        attempts = 0
        last_exc = last_503 = None
        while attempts <= self.retry_budget:
            rep = self._pick_wait(exclude=exclude, session=session)
            if rep is None:
                break
            try:
                if hedge:
                    st, hd, data = self._hedged_call(rep, path, body,
                                                     exclude)
                else:
                    st, hd, data = self._call(rep, path, body)
            except Exception as e:    # noqa: BLE001 — transport/injected
                logger.warning("%s: dispatch to %s failed: %s: %s",
                               self.name, rep.rid, type(e).__name__, e)
                last_exc = e
                exclude.add(rep.rid)
                attempts += 1
                self.metrics.count("retries_total" if route == "infer"
                                   else "failovers_total")
                continue
            if st == 503:
                self._honor_503(rep, hd)
                last_503 = (st, hd, data)
                exclude.add(rep.rid)
                attempts += 1
                continue
            if st >= 500:
                last_exc = RuntimeError(f"replica {rep.rid} answered "
                                        f"{st}")
                exclude.add(rep.rid)
                attempts += 1
                self.metrics.count("retries_total" if route == "infer"
                                   else "failovers_total")
                continue
            self.metrics.observe_response(time.perf_counter() - t0)
            fwd = {k: v for k, v in hd.items()
                   if k.lower() in ("retry-after",)}
            return st, fwd, data
        if last_503 is not None:
            st, hd, data = last_503
            fwd = {k: v for k, v in hd.items()
                   if k.lower() == "retry-after"}
            # internal marker (stripped by the handler): this 503 came
            # FROM a replica — real upstream backpressure, unlike the
            # router's own no-ready-replica 503 below, which must not
            # drive the AIMD multiplicative decrease
            fwd["X-Upstream-Shed"] = "1"
            return st, fwd, data
        if last_exc is not None:
            self.metrics.reject("exhausted")
            return 502, {}, json.dumps(
                {"error": f"all dispatch attempts failed: "
                          f"{type(last_exc).__name__}: {last_exc}"}
            ).encode()
        self.metrics.reject("unready")
        return 503, {"Retry-After": self._retry_after_hint()}, json.dumps(
            {"error": "no ready replica"}).encode()

    # ------------------------------------------------------------ render

    def ready(self):
        now = self._clock()
        with self._lock:
            return any(r.ready and now >= r.not_before
                       and r.breaker.state != "open"
                       for r in self._replicas.values())

    def replica_states(self):
        with self._lock:
            reps = list(self._replicas.values())
        return {
            r.rid: {
                "url": r.base_url, "ready": r.ready,
                "queue_depth": r.queue_depth, "inflight": r.inflight,
                "breaker": r.breaker.state, "role": r.role,
            } for r in reps
        }

    def render_prometheus(self):
        m, n = self.metrics, self.metrics.name
        lines = []

        def emit(metric, value, help_, mtype="counter", labels=""):
            lines.append(f"# HELP {n}_{metric} {help_}")
            lines.append(f"# TYPE {n}_{metric} {mtype}")
            lines.append(f"{n}_{metric}{labels} {value}")

        def emit_labeled(metric, table, help_, label="replica"):
            lines.append(f"# HELP {n}_{metric} {help_}")
            lines.append(f"# TYPE {n}_{metric} counter")
            for k in sorted(table):
                lines.append(f'{n}_{metric}{{{label}="{k}"}} {table[k]}')

        snap = m.snapshot()
        emit_labeled("requests_total", snap["requests_total"],
                     "requests admitted, by route", label="route")
        emit("responses_total", snap["responses_total"],
             "requests answered with an upstream response")
        emit_labeled("rejected_total", snap["rejected"],
                     "requests the router shed, by reason", label="reason")
        emit_labeled("dispatch_total", snap["dispatch_total"],
                     "upstream dispatch attempts, by replica")
        emit_labeled("dispatch_errors_total", snap["dispatch_errors_total"],
                     "upstream dispatch failures, by replica")
        for field, help_ in (
                ("retries_total", "idempotent infer re-dispatches"),
                ("failovers_total", "generate re-dispatches after an "
                                    "upstream failure"),
                ("midstream_failovers_total",
                 "generate failovers with tokens already streamed "
                 "(continuation resubmitted, stream stayed bit-identical)"),
                ("hedges_total", "hedged infer requests fired"),
                ("hedge_wins_total", "hedged requests answered first"),
                ("client_disconnects_total",
                 "downstream streams dropped by the client (upstream "
                 "closed so the replica reclaims the slot)"),
                ("tokens_proxied_total", "generation tokens streamed "
                                         "through the router")):
            emit(field, snap[field], help_)
        emit_labeled("kv_handoffs_total", snap["kv_handoffs_total"],
                     "disaggregated prefill->decode KV handoffs resolved "
                     "through this router, by outcome (serving/"
                     "transfer.py)", label="outcome")
        emit("kv_handoff_bytes_total", snap["kv_handoff_bytes_total"],
             "KV chain bytes shipped replica-to-replica for handoffs "
             "this router brokered")
        lines.append(f"# HELP {n}_kv_handoff_seconds receive-side "
                     "fetch+verify+deliver latency of brokered KV "
                     "handoffs, recent-window quantiles")
        lines.append(f"# TYPE {n}_kv_handoff_seconds summary")
        for q, v in m.kv_handoff.percentiles(_QUANTILES).items():
            lines.append(f'{n}_kv_handoff_seconds{{quantile="0.{q}"}} '
                         f"{v:.6f}")
        lines.append(f"{n}_kv_handoff_seconds_count {m.kv_handoff.count}")
        emit_labeled("ejections_total", snap["ejections_total"],
                     "replicas ejected from rotation (consecutive "
                     "dispatch failures)")
        emit_labeled("readmissions_total", snap["readmissions_total"],
                     "ejected replicas readmitted by a half-open probe")
        lines.append(f"# HELP {n}_latency_seconds request wall latency at "
                     "the router, recent-window quantiles")
        lines.append(f"# TYPE {n}_latency_seconds summary")
        for q, v in m.latency.percentiles(_QUANTILES).items():
            lines.append(f'{n}_latency_seconds{{quantile="0.{q}"}} '
                         f"{v:.6f}")
        lines.append(f"{n}_latency_seconds_count {m.latency.count}")
        lines.append(f"# HELP {n}_ttft_seconds fleet-wide time to first "
                     "token as routed clients feel it, recent-window "
                     "quantiles")
        lines.append(f"# TYPE {n}_ttft_seconds summary")
        for q, v in m.ttft.percentiles(_QUANTILES).items():
            lines.append(f'{n}_ttft_seconds{{quantile="0.{q}"}} {v:.6f}')
        lines.append(f"{n}_ttft_seconds_count {m.ttft.count}")
        states = self.replica_states()
        for metric, key, help_ in (
                ("replica_ready", "ready", "last /readyz verdict "
                                           "(1 ready / 0 not)"),
                ("replica_queue_depth", "queue_depth",
                 "last polled queue depth"),
                ("replica_inflight", "inflight",
                 "router-side in-flight requests")):
            lines.append(f"# HELP {n}_{metric} {help_}")
            lines.append(f"# TYPE {n}_{metric} gauge")
            for rid in sorted(states):
                v = states[rid][key]
                lines.append(f'{n}_{metric}{{replica="{rid}"}} {int(v)}')
        lines.append(f"# HELP {n}_replica_breaker_state outlier-ejection "
                     "breaker (0 closed, 1 half-open, 2 open)")
        lines.append(f"# TYPE {n}_replica_breaker_state gauge")
        for rid in sorted(states):
            lines.append(
                f'{n}_replica_breaker_state{{replica="{rid}"}} '
                f"{BREAKER_STATES.get(states[rid]['breaker'], 0)}")
        # contributed sections: the overload controller's overload_*/
        # brownout_* lines, plus anything registered on
        # extra_render_fns (the autoscaler's autoscaler_* lines)
        for fn in list(self.extra_render_fns):
            try:
                lines.extend(fn())
            except Exception:   # noqa: BLE001 — a dying contributor
                pass            # must not kill /metrics
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------ serve

    def start(self, host="127.0.0.1", port=0):
        """Bind the router's HTTP front-end (port 0 = ephemeral) and
        serve it on a daemon thread; returns the httpd (``.port`` holds
        the bound port)."""
        httpd = ThreadingHTTPServer((host, port), RouterHandler)
        httpd.daemon_threads = True
        httpd.router = self
        httpd.port = httpd.server_address[1]
        self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name=f"{self.name}-http").start()
        logger.info("%s: routing on http://%s:%d", self.name, host,
                    httpd.port)
        return httpd

    def close(self):
        self._closed.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # the request's root span (obs/trace.py); NULL outside do_POST or
    # with tracing disabled
    _obs = obstrace.NULL
    # final status code sent downstream this request (drives the AIMD
    # release: 429/503 = upstream congestion, 200 = clean completion)
    _status = None
    # True when this request's shedding response originated at a REPLICA
    # (real backpressure) rather than the router itself
    _upstream_shed = False
    # streaming outcome: None for unary, True when the done record went
    # out, False when the stream broke after headers (status frozen at
    # 200 — must not count as a completion for AIMD/drain-rate)
    _stream_ok = None

    def log_message(self, fmt, *args):
        logger.debug("router http: " + fmt, *args)

    def _reply(self, code, payload, content_type="application/json",
               headers=None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self._obs.trace_id:
            self.send_header("X-Trace-Id", self._obs.trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    # ------------------------------------------------------------ GET

    def do_GET(self):
        # keep-alive: drop any previous POST's span before replying
        self._obs = obstrace.NULL
        router = self.server.router
        if self.path == "/healthz":
            self._reply(200, {"status": "ok",
                              "replicas": router.replica_states()})
        elif self.path == "/readyz":
            if router.ready():
                self._reply(200, {"status": "ready"})
            else:
                self._reply(503, {"status": "unready",
                                  "reasons": ["no_ready_replica"]},
                            headers={"Retry-After":
                                     router._retry_after_hint()})
        elif self.path == "/metrics":
            self._reply(200, router.render_prometheus().encode(),
                        content_type="text/plain; version=0.0.4")
        elif self.path == "/debug/traces":
            self._reply(200, obstrace.debug_payload())
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    # ------------------------------------------------------------ POST

    def _read_body(self):
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length)

    def do_POST(self):
        # the fleet-wide request root: a downstream traceparent (another
        # tier above us) continues that trace, a direct client starts
        # one; every dispatch/leg below parents here and forwards the
        # trace to the replicas.
        ctx = obstrace.extract(self.headers.get("traceparent"))
        with obstrace.span("router.request", ctx=ctx, root=True,
                           route=self.path) as sp, \
                log_context(trace_id=sp.trace_id,
                            request_id=sp.span_id):
            self._obs = sp
            self._route_post()

    def _route_post(self):
        router = self.server.router
        if self.path not in ("/v1/infer", "/v1/generate"):
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        body = self._read_body()
        req = None
        if self.path == "/v1/generate":
            try:
                req = json.loads(body)
                assert isinstance(req, dict)
            except Exception:   # noqa: BLE001 — malformed: a replica
                req = None      #                 will 400 it
        # adaptive overload control (serving/overload.py): one permit
        # per request, held across every retry/failover leg.  Priority
        # rides the body ("priority") or the X-Priority header; a shed
        # is an honest 429 with a drain-rate-derived Retry-After.
        priority = OverloadController.parse_priority(
            (req or {}).get("priority") or self.headers.get("X-Priority"))
        deadline_ms = (req or {}).get("deadline_ms")
        if not isinstance(deadline_ms, (int, float)) or deadline_ms <= 0:
            deadline_ms = None
        try:
            router.overload.admit(priority, deadline_ms=deadline_ms)
        except ShedError as e:
            router.metrics.reject("shed")
            self._obs.set(shed=e.reason, priority=priority)
            self._reply(429, {"error": f"overloaded ({e.reason}): {e}",
                              "priority": priority},
                        headers={"Retry-After": e.retry_after_s})
            return
        self._status = None
        # overloaded=True only for REPLICA-origin backpressure: a 429
        # here is always an upstream pass-through (the router's own shed
        # raised above, before the permit existed), a 503 only when the
        # upstream marker says so — the router's own "no ready replica"
        # 503 (a restart window, not congestion) must not collapse the
        # AIMD limit
        self._upstream_shed = False
        self._stream_ok = None
        try:
            self._route_admitted(router, body, req)
        finally:
            st = self._status
            # a stream whose status line froze at 200 but later broke
            # (failover budget exhausted, client gone) is NOT a
            # completion — it must feed neither the drain-rate estimate
            # nor the additive limit increase
            router.overload.release(
                overloaded=st == 429
                or (st == 503 and self._upstream_shed),
                completed=st == 200 and self._stream_ok is not False)

    def _strip_shed_marker(self, hd):
        if hd.pop("X-Upstream-Shed", None) is not None:
            self._upstream_shed = True
        return hd

    def _route_admitted(self, router, body, req):
        if self.path == "/v1/infer":
            st, hd, data = router.route_unary(
                "infer", "/v1/infer", body,
                hedge=router.hedge_ms != 0
                and router.overload.hedging_allowed())
            self._reply(st, data, headers=self._strip_shed_marker(hd))
            return
        session = (req or {}).get("session")
        if not isinstance(session, str):
            session = None          # affinity keys must be hashable strs
        if req is None or not req.get("stream"):
            # brownout rung 2: cap the effective max_tokens of a unary
            # generate before it reaches a replica
            if req is not None \
                    and router.overload.ladder.capping_tokens():
                cur = req.get("max_tokens")
                if not isinstance(cur, int) or cur < 1:
                    cur = FLAGS.serving_gen_max_tokens
                req["max_tokens"] = router.overload.cap_max_tokens(cur)
                body = json.dumps(req).encode()
            t_start = time.perf_counter()
            st, hd, data = router.route_unary(
                "generate", "/v1/generate", body, session=session)
            self._strip_shed_marker(hd)
            if st == 200:
                # fleet-wide TTFT as the CLIENT felt it: the replica-
                # reported ttft_ms misses router-side queueing/retry/
                # failover time (exactly the wait the autoscaler must
                # see), so add back everything the router spent beyond
                # the replica's own post-first-token generation time
                try:
                    out = json.loads(data)
                    rep_ttft = out.get("ttft_ms")
                    rep_lat = out.get("latency_ms")
                    if isinstance(rep_ttft, (int, float)):
                        ttft_ms = rep_ttft
                        if isinstance(rep_lat, (int, float)) \
                                and rep_lat >= rep_ttft:
                            elapsed_ms = (time.perf_counter()
                                          - t_start) * 1e3
                            ttft_ms = max(rep_ttft, elapsed_ms
                                          - (rep_lat - rep_ttft))
                        router.metrics.observe_ttft(ttft_ms / 1e3)
                except Exception:   # noqa: BLE001 — advisory only
                    pass
            self._reply(st, data, headers=hd)
            return
        self._generate_stream(router, req, session)

    # ------------------------------------------------- streaming failover

    def _generate_stream(self, router, req, session):
        """Proxy a streaming /v1/generate with CROSS-REPLICA MID-STREAM
        FAILOVER: tokens forwarded so far are tracked; when the upstream
        replica dies before its ``done`` record, the stream resumes on a
        healthy replica as a continuation (``replay`` = prompt-relative
        tokens already delivered) — bit-identical by greedy determinism.
        A client disconnect closes the upstream connection, firing the
        replica's ``abandon()`` slot reclamation."""
        t0 = time.perf_counter()
        m = router.metrics
        m.accepted("generate")
        orig_replay = list(req.get("replay") or [])
        eff_max = req.get("max_tokens")
        if not isinstance(eff_max, int) or eff_max < 1:
            # the replica-side default; the router must know the cap to
            # compute a continuation's remaining budget.  This reads the
            # ROUTER process's flags — bit-identical failover for
            # requests that omit max_tokens requires the replicas to run
            # with the same serving_gen_max_tokens
            eff_max = FLAGS.serving_gen_max_tokens
        # brownout rung 2: cap the stream's token budget (greedy decode
        # means the capped stream is a bit-identical PREFIX of the full
        # one — quality degrades to a shorter answer, never a wrong one)
        eff_max = router.overload.cap_max_tokens(eff_max)
        eos_id = req.get("eos_id")
        delivered = []                # NEW tokens forwarded downstream
        state = {"headers_sent": False}   # shared with the leg proxy: a
        # 200 leg that dies before its first token must not let a later
        # leg emit a second status line
        attempts = 0
        exclude = set()
        last_shed = None              # last orderly 503 (status, hd, data)
        # disaggregated prefill/decode (serving/transfer.py): when the ready set
        # holds both roles, split a fresh stream into a PREFILL leg
        # (max_tokens=1 on a prefill-role replica — its done record is
        # the handoff boundary, not the stream's end) and a DECODE leg
        # that ships chain key + continuation; the decode replica pulls
        # the KV blocks over /v1/kv/export.  Any prefill death or
        # transfer failure degrades to the plain continuation-replay
        # path below — recompute, bit-identical by greedy determinism.
        prompt_ids = req.get("prompt")
        disagg = (router.disagg_active()
                  and isinstance(prompt_ids, list) and prompt_ids
                  and all(isinstance(t, int) for t in prompt_ids))
        handoff_src = None        # prefill replica URL once the boundary
        #                           lands (stays attached across decode-
        #                           leg failovers)

        def send_headers():
            if state["headers_sent"]:
                return
            state["headers_sent"] = True
            self._status = 200
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            if self._obs.trace_id:
                self.send_header("X-Trace-Id", self._obs.trace_id)
            self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data
                             + b"\r\n")

        def finish(done_rec):
            out = dict(done_rec)
            # the decode replica reports how its leg got the context
            # (serving/transfer.py outcome dict) — fold it into the
            # router's fleet-wide handoff counters/latency histogram
            hand = out.get("kv_handoff")
            if isinstance(hand, dict) and hand.get("outcome"):
                ms = hand.get("ms")
                m.observe_kv_handoff(
                    hand["outcome"], hand.get("bytes") or 0,
                    ms / 1e3 if isinstance(ms, (int, float)) else None)
            out["tokens"] = list(delivered)
            out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            chunk(out)
            self.wfile.write(b"0\r\n\r\n")
            self._stream_ok = True
            m.observe_response(time.perf_counter() - t0)

        def fail_stream(msg):
            self._stream_ok = False
            if not state["headers_sent"]:
                self._reply(502, {"error": msg})
                return
            try:
                chunk({"error": msg})
                self.wfile.write(b"0\r\n\r\n")
            except Exception:   # noqa: BLE001 — client gone too
                pass
            self.close_connection = True

        while True:
            # a finished stream needs no upstream at all: synthesize the
            # done record (a failover can land exactly on the boundary)
            if delivered and eos_id is not None \
                    and delivered[-1] == eos_id:
                send_headers()
                finish({"done": True, "finish_reason": "eos",
                        "ttft_ms": None})
                return
            if len(delivered) >= eff_max:
                send_headers()
                finish({"done": True, "finish_reason": "length",
                        "ttft_ms": None})
                return
            if attempts > router.retry_budget:
                m.reject("exhausted")
                fail_stream("stream failover budget exhausted")
                return
            prefer = None
            if disagg:
                prefer = ("prefill" if not delivered
                          and handoff_src is None else "decode")
            # the prefill leg ignores session affinity (the session
            # belongs with the decode replica that will own the stream)
            rep = router._pick_wait(
                exclude=exclude,
                session=None if prefer == "prefill" else session,
                prefer_role=prefer)
            if rep is None:
                if last_shed is not None and not state["headers_sent"]:
                    st, hd, data = last_shed
                    self._upstream_shed = True    # replica-origin 503
                    self._reply(st, data,
                                headers={k: v for k, v in hd.items()
                                         if k.lower() == "retry-after"})
                    return
                m.reject("unready")
                if not state["headers_sent"]:
                    self._reply(503, {"error": "no ready replica"},
                                headers={"Retry-After":
                                         router._retry_after_hint()})
                else:
                    fail_stream("no ready replica for mid-stream "
                                "failover")
                return
            leg = dict(req)
            leg["stream"] = True
            boundary_leg = disagg and prefer == "prefill"
            if boundary_leg:
                # stop at the first token: the prefill leg's done record
                # is the handoff boundary, swallowed below — the decode
                # leg continues the stream
                leg["max_tokens"] = 1
            else:
                leg["max_tokens"] = eff_max - len(delivered)
            replay = orig_replay + delivered
            if replay:
                leg["replay"] = replay
            elif "replay" in leg:
                del leg["replay"]
            if handoff_src is not None and not boundary_leg \
                    and handoff_src != rep.base_url:
                # ship the chain key: the decode replica pulls the
                # prefill replica's KV blocks over /v1/kv/export before
                # admission (a failed pull is its recompute fallback)
                leg["kv_handoff"] = {
                    "source": handoff_src,
                    "tokens": [int(t) for t in prompt_ids] + orig_replay}
            elif "kv_handoff" in leg:
                # never forward a client-supplied hint past the replica
                # that already owns the context
                del leg["kv_handoff"]
            with router._lock:
                rep.inflight += 1
            try:
                # one upstream leg = one span: a failed-over stream shows
                # leg[replica=r0] then leg[replica=r1] on the same trace
                with obstrace.span("router.leg", replica=rep.rid,
                                   attempt=attempts, replay=len(replay),
                                   boundary=boundary_leg):
                    outcome = self._proxy_leg(
                        router, rep, leg, delivered, send_headers, chunk,
                        (lambda rec: None) if boundary_leg else finish,
                        t0)
            finally:
                with router._lock:
                    rep.inflight -= 1
            if outcome[0] == "done":
                router._record(rep, ok=True)
                if boundary_leg:
                    # the 1-token prefill leg completed: this is the
                    # HANDOFF, not the stream's end — loop into the
                    # decode leg with the chain key attached
                    handoff_src = rep.base_url
                    self._obs.event("kv_handoff_boundary",
                                    replica=rep.rid)
                    continue
                return
            if outcome[0] == "client_gone":
                # the downstream reader left: upstream already closed
                # (abandon() fires on the replica); nothing more to say.
                # Not a completion — the work was abandoned, not drained
                self._stream_ok = False
                m.count("client_disconnects_total")
                router._record(rep, ok=True)
                self.close_connection = True
                return
            if outcome[0] == "shed":       # orderly 503 before any bytes
                router._record(rep, ok=True)
                router._honor_503(rep, outcome[1])
                last_shed = (503, outcome[1], outcome[2])
                exclude.add(rep.rid)
                attempts += 1
                continue
            if outcome[0] == "client_error":   # 4xx pass-through
                router._record(rep, ok=True)
                st, hd, data = outcome[1:]
                if state["headers_sent"]:
                    # a failover leg got rejected AFTER the 200 + chunked
                    # headers went out: the status line is spent, so end
                    # the stream with an orderly error record instead of
                    # writing a second status line into the body
                    fail_stream(f"failover leg rejected with {st}: "
                                f"{data.decode(errors='replace')[:200]}")
                else:
                    # a replica-origin 429 (its generation queue is
                    # full) is a SHED: the Retry-After must survive the
                    # pass-through — every shed is an honest 429
                    if st == 429:
                        self._upstream_shed = True
                    self._reply(st, data,
                                headers={k: v for k, v in hd.items()
                                         if k.lower() == "retry-after"})
                return
            # upstream failed (transport death, 5xx, error record):
            # charge the breaker and fail over with the delivered prefix
            router._record(rep, ok=False)
            exclude.add(rep.rid)
            attempts += 1
            if delivered:
                m.count("midstream_failovers_total")
                self._obs.event("midstream_failover", replica=rep.rid,
                                delivered=len(delivered))
                logger.warning(
                    "%s: replica %s died mid-stream after %d token(s); "
                    "failing over with a continuation", router.name,
                    rep.rid, len(delivered))
            m.count("failovers_total")

    def _proxy_leg(self, router, rep, leg, delivered,
                   send_headers, chunk, finish, t0):
        """One upstream streaming leg.  Returns a tagged outcome:
        ("done",) — the stream completed downstream;
        ("client_gone",) — the downstream client dropped;
        ("shed", headers, body) — orderly 503 before any stream bytes;
        ("client_error", status, headers, body) — 4xx pass-through;
        ("pre", reason) — upstream failed before this leg streamed;
        ("mid", reason) — upstream failed after this leg streamed."""
        m = router.metrics
        streamed_here = False
        try:
            conn, resp = router._dispatch(rep, "POST", "/v1/generate",
                                          json.dumps(leg).encode(),
                                          stream=True)
        except Exception as e:    # noqa: BLE001 — transport/injected
            return ("pre", f"{type(e).__name__}: {e}")
        try:
            if resp.status != 200:
                data = resp.read()
                hd = dict(resp.getheaders())
                if resp.status == 503:
                    return ("shed", hd, data)
                if resp.status < 500:
                    return ("client_error", resp.status, hd, data)
                return ("pre", f"replica answered {resp.status}")
            send_headers()
            while True:
                line = resp.readline()
                if not line:
                    # upstream EOF without a done record: the replica
                    # died (kill -9 closes the socket mid-chunk)
                    return (("mid" if streamed_here or delivered
                             else "pre"), "upstream EOF before done")
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    return ("mid", "malformed upstream chunk")
                if "token" in rec:
                    delivered.append(int(rec["token"]))
                    if len(delivered) == 1:
                        self._obs.event("first_token")
                        m.observe_ttft(time.perf_counter() - t0)
                    streamed_here = True
                    m.count("tokens_proxied_total")
                    try:
                        chunk({"token": int(rec["token"])})
                    except Exception:   # noqa: BLE001 — client gone:
                        return ("client_gone",)
                elif rec.get("done"):
                    try:
                        finish(rec)
                    except Exception:   # noqa: BLE001
                        return ("client_gone",)
                    return ("done",)
                elif "error" in rec:
                    # replica-side mid-stream failure record: its own
                    # recovery gave up — fail over across replicas
                    return (("mid" if streamed_here or delivered
                             else "pre"),
                            f"upstream error record: {rec['error']}")
        except Exception as e:    # noqa: BLE001 — read failure = death
            return (("mid" if streamed_here or delivered else "pre"),
                    f"{type(e).__name__}: {e}")
        finally:
            # closing the upstream connection is ALSO the disconnect
            # propagation path: an abandoned leg's replica sees the
            # socket close and reclaims the slot at the next token
            conn.close()


# ------------------------------------------------------------------ smoke


def demo_reference(replica_args, prompts, n_tokens, **engine_kw):
    """The smoke replicas' demo LM in process: ``server.parse_args`` of
    the replicas' own arguments builds the same engine from the same
    seed on the same device, and each prompt's greedy stream is read one
    request at a time.  ``engine_kw`` overrides ``build_gen_batcher``
    keys; returns (streams, the reference's engine)."""
    from paddle_tpu_torch.serving import server
    args = server.parse_args(["--demo-generate", *replica_args])
    gen = server.batcher_from_args(args, **engine_kw)
    try:
        return [gen.submit([int(t) for t in p], max_tokens=n_tokens)
                .result(300)["tokens"] for p in prompts], gen.engine
    finally:
        gen.close()


def _stream_generate(port, prompt, n_tokens, replay=None, handoff=None,
                     on_token=None, timeout=300):
    """One streaming /v1/generate client: (tokens, done record)."""
    body = {"prompt": [int(t) for t in prompt], "max_tokens": n_tokens,
            "stream": True}
    if replay:
        body["replay"] = [int(t) for t in replay]
    if handoff is not None:
        body["kv_handoff"] = handoff
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        toks, done = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            rec = json.loads(line)
            if "token" in rec:
                toks.append(rec["token"])
                if on_token is not None:
                    on_token(len(toks))
            if rec.get("done"):
                done = rec
                break
        return toks, done
    finally:
        conn.close()


def _smoke(replica_args=()):
    """Fleet self-test: 2 tiny demo replicas on ephemeral ports behind
    the router, concurrent streaming /v1/generate clients, kill -9 one
    replica MID-STREAM — every stream must finish bit for bit an
    in-process engine built from the replicas' seed, the router must
    report the failover, and the supervisor must restart the victim to
    readiness.  ONE JSON line; returns the exit code."""
    import numpy as np
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor

    errs = []
    out = {"metric": "fleet smoke (replica supervisor + health-checked "
                     "router, kill -9 mid-stream)",
           "vs_baseline": None}
    n_clients, n_tokens, max_len = 6, 24, 64
    # the replicas' demo LM; the injected decode-step hang paces tokens
    # (~25ms each) so the kill reliably lands MID-stream
    base_args = ["--gen-slots", "4", "--gen-max-len", str(max_len),
                 "--gen-prefill-buckets", "8,16",
                 "--gen-max-tokens", str(n_tokens), *replica_args]
    extra = base_args + [
        "--fault-spec",
        "serving.decode_step:every=1,action=hang,hang_s=0.025"]
    sup = ReplicaSupervisor(n_replicas=2, extra_args=extra,
                            backoff_base_s=0.3, seed=0,
                            name="fleet_smoke")
    router = Router(supervisor=sup, poll_interval_s=0.1,
                    eject_threshold=2, eject_cooldown_s=1.0,
                    retry_budget=3, name="router_smoke")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, 3 + 2 * i).astype(np.int64)
               for i in range(n_clients)]
    try:
        oracle, _eng = demo_reference(base_args, prompts, n_tokens)
        sup.start()
        if not sup.wait_ready(timeout=240):
            errs.append("replicas never became ready")
            raise RuntimeError("fleet warm-up timeout")
        httpd = router.start(port=0)
        deadline = time.monotonic() + 30
        while not router.ready() and time.monotonic() < deadline:
            time.sleep(0.05)
        base = f"http://127.0.0.1:{httpd.port}"

        results = [None] * n_clients
        first_token = threading.Barrier(n_clients + 1, timeout=120)

        def hit(i):
            armed = [True]

            def seen(n):
                if armed[0] and n >= 2:
                    armed[0] = False
                    first_token.wait()

            try:
                toks, done = _stream_generate(httpd.port, prompts[i],
                                              n_tokens, on_token=seen)
                if armed[0]:
                    first_token.wait()      # finished before 2 tokens(!)
                results[i] = {"tokens": toks, "done": done}
            except Exception as e:      # noqa: BLE001
                errs.append(f"client {i}: {type(e).__name__}: {e}")
                if armed[0]:
                    try:
                        first_token.wait()
                    except threading.BrokenBarrierError:
                        pass

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        # kill -9 one replica once EVERY stream is visibly mid-decode
        first_token.wait()
        sup.kill("r0", signal.SIGKILL)
        out["victim_killed"] = True
        for t in threads:
            t.join(180)
        ok = sum(1 for r in results if r is not None and r["done"])
        bit_identical = all(
            r is not None and r["tokens"] == oracle[i]
            and r["done"] and r["done"]["tokens"] == oracle[i]
            for i, r in enumerate(results))
        snap = router.metrics.snapshot()
        import urllib.request
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            mtext = r.read().decode()
        out.update(
            streams_ok=ok,
            bit_identical=bool(bit_identical),
            midstream_failovers=snap["midstream_failovers_total"],
            failovers=snap["failovers_total"],
            tokens_proxied=snap["tokens_proxied_total"],
            router_metrics_sane=(
                "midstream_failovers_total" in mtext
                and 'replica_ready{replica="r1"} 1' in mtext),
        )
        # supervision evidence: the victim restarts (backoff) and comes
        # back ready — the router readmits it automatically
        restarted = sup.wait_ready(timeout=240, rids=("r0",))
        fsnap = sup.snapshot()
        out["restarted_ready"] = bool(restarted)
        out["victim_restarts"] = fsnap["r0"]["restarts_total"]
        out["backoff_delays_s"] = fsnap["r0"]["backoff_delays_s"]
        checks = [
            ok == n_clients,
            bool(bit_identical),
            snap["midstream_failovers_total"] >= 1,
            bool(out["router_metrics_sane"]),
            bool(restarted) and fsnap["r0"]["restarts_total"] >= 1,
        ]
    except Exception as e:      # noqa: BLE001 — a harness failure must
        errs.append(f"smoke: {type(e).__name__}: {e}")
        checks = [False]
    finally:
        try:
            router.close()
        finally:
            sup.stop()
    out["value"] = sum(bool(c) for c in checks)
    out["unit"] = f"checks_ok/{len(checks)}"
    if errs:
        out["errors"] = errs[:5]
    print(json.dumps(out), flush=True)
    return 0 if all(checks) else 2


def _smoke_disagg(replica_args=()):
    """Disaggregated-serving self-test: ONE prefill-role + ONE
    decode-role replica behind the router, concurrent streaming clients
    handed off mid-flight — each new prompt prefills on r0, crosses the
    socket transport at the first token (chain key + continuation; the
    decode replica pulls the KV blocks over /v1/kv/export), and decodes
    on r1.  Every stream must finish bit for bit a mixed in-process
    engine of the same configuration; the handoff counters on BOTH
    replicas' /metrics and the router's must prove the blocks really
    crossed the socket; a prompt below the analytic crossover must take
    the recompute fallback; and after kill -9 of the prefill replica a
    handoff against the dead source must fall back to recompute, still
    bit for bit.  ONE JSON line; returns the exit code."""
    import urllib.request
    import numpy as np
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor

    errs = []
    out = {"metric": "disaggregated serving smoke (prefill/decode "
                     "replicas, socket KV handoff, kill -9 fallback)",
           "vs_baseline": None}
    n_tokens, max_len, bs = 24, 64, 8
    # block-aligned prompts: the handed-off chain covers the WHOLE
    # prompt, so the decode replica seats it with zero prefill chunk
    # lanes.  Which lengths the analytic model hands off is read from
    # the reference engine (the same model on the same device).
    lengths = [32, 40, 16, 32]
    base_args = ["--gen-slots", "4", "--gen-max-len", str(max_len),
                 "--gen-prefill-buckets", "8,16",
                 "--gen-max-tokens", str(n_tokens),
                 "--prefill-chunk", str(bs),
                 "--kv-layout", "paged", "--kv-block-size", str(bs),
                 "--kv-num-blocks", "49", "--kv-prefix-cache", "1",
                 "--kv-host-bytes", str(64 << 20), *replica_args]
    extra = base_args + [
        "--fault-spec",
        "serving.decode_step:every=1,action=hang,hang_s=0.015"]
    sup = ReplicaSupervisor(n_replicas=2, roles=("prefill", "decode"),
                            extra_args=extra, backoff_base_s=0.3, seed=0,
                            name="disagg_smoke")
    router = Router(supervisor=sup, poll_interval_s=0.1,
                    eject_threshold=2, eject_cooldown_s=1.0,
                    retry_budget=3, name="router_disagg")

    def outcome_count(text, outcome):
        m = re.search(r'^\S*_kv_handoffs_total\{outcome="'
                      + outcome + r'"\} (\d+)\s*$', text, re.MULTILINE)
        return int(m.group(1)) if m else 0

    def fetch_metrics(url):
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            return r.read().decode()

    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 256, n).astype(np.int64)
               for n in lengths + [32, 32]]   # +kill-fallback, +post
    try:
        oracle, ref = demo_reference(base_args, prompts, n_tokens)
        handed = [bool(ref._handoff_predicted_faster(n // bs * bs)[0])
                  for n in lengths]
        out["analytic_handoff"] = handed
        sup.start()
        if not sup.wait_ready(timeout=240):
            errs.append("replicas never became ready")
            raise RuntimeError("fleet warm-up timeout")
        eps = dict(sup.endpoints())
        prefill_url, decode_url = eps["r0"], eps["r1"]
        httpd = router.start(port=0)
        # the router must have PROBED both roles before disaggregated
        # routing activates (role rides the /metrics poll)
        deadline = time.monotonic() + 30
        while not router.disagg_active() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        out["disagg_active"] = router.disagg_active()

        # ---- phase 1: concurrent streams, handed off mid-flight ----
        results = [None] * len(lengths)

        def hit(i):
            try:
                results[i] = _stream_generate(httpd.port, prompts[i],
                                              n_tokens)
            except Exception as e:      # noqa: BLE001
                errs.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(lengths))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        done_ok = sum(1 for r in results
                      if r is not None and r[1] is not None)
        bit_identical = all(
            r is not None and r[0] == oracle[i]
            and r[1] and r[1]["tokens"] == oracle[i]
            for i, r in enumerate(results))
        hand_outcomes = [
            (r[1].get("kv_handoff") or {}).get("outcome")
            if r is not None and r[1] else None for r in results]
        # the prompts the analytic model hands off must have RECEIVED a
        # real handoff; the others must have fallen back (analytic)
        outcomes_as_priced = all(
            hand_outcomes[i] == ("received" if handed[i] else "fallback")
            for i in range(len(lengths)))
        pre_text = fetch_metrics(prefill_url)
        dec_text = fetch_metrics(decode_url)
        sent = outcome_count(pre_text, "sent")
        received = outcome_count(dec_text, "received")
        bytes_m = re.search(r"^\S*_kv_handoff_bytes_total (\d+)\s*$",
                            dec_text, re.MULTILINE)
        handoff_bytes = int(bytes_m.group(1)) if bytes_m else 0
        snap = router.metrics.snapshot()
        n_handed = sum(handed)
        out.update(
            streams_ok=done_ok,
            bit_identical=bool(bit_identical),
            handoff_outcomes=hand_outcomes,
            prefill_sent=sent,
            decode_received=received,
            decode_handoff_bytes=handoff_bytes,
            router_handoffs=snap["kv_handoffs_total"],
            router_handoff_ms_p50=snap["kv_handoff_ms"].get("p50"),
        )

        # ---- phase 2: kill -9 the prefill replica; a handoff against
        # the dead source must fall back to recompute, bit for bit
        sup.kill("r0", signal.SIGKILL)
        out["victim_killed"] = True
        time.sleep(0.2)                  # let the socket really die
        p_kill, o_kill = prompts[len(lengths)], oracle[len(lengths)]
        dec_port = urlsplit(decode_url).port
        toks, done = _stream_generate(
            dec_port, p_kill, n_tokens - 1, replay=o_kill[:1],
            handoff={"source": prefill_url,
                     "tokens": [int(t) for t in p_kill]})
        kill_hand = (done or {}).get("kv_handoff") or {}
        kill_fallback_ok = (done is not None
                            and toks == o_kill[1:]
                            and done["tokens"] == o_kill[1:]
                            and kill_hand.get("outcome") == "fallback")
        out["kill_fallback_outcome"] = kill_hand
        fallbacks_after = outcome_count(fetch_metrics(decode_url),
                                        "fallback")
        out["decode_fallbacks"] = fallbacks_after

        # ---- phase 3: the fleet keeps serving THROUGH the kill — a
        # fresh stream via the router (its view of r0 may still be
        # stale) must complete bit for bit on what's left
        p_post, o_post = prompts[len(lengths) + 1], oracle[len(lengths) + 1]
        toks3, done3 = _stream_generate(httpd.port, p_post, n_tokens)
        post_ok = (done3 is not None and toks3 == o_post
                   and done3["tokens"] == o_post)
        out["post_kill_stream_ok"] = bool(post_ok)

        checks = [
            bool(out["disagg_active"]),
            done_ok == len(lengths),
            bool(bit_identical),
            bool(outcomes_as_priced) and 0 < n_handed < len(lengths),
            sent >= n_handed and received >= n_handed
            and handoff_bytes > 0,
            snap["kv_handoffs_total"].get("received", 0) >= n_handed
            and snap["kv_handoffs_total"].get("fallback", 0) >= 1,
            bool(kill_fallback_ok)
            and fallbacks_after >= len(lengths) - n_handed + 1,
            bool(post_ok),
        ]
    except Exception as e:      # noqa: BLE001 — a harness failure must
        errs.append(f"smoke: {type(e).__name__}: {e}")
        checks = [False]
    finally:
        try:
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
        prog="python -m paddle_tpu_torch.serving.router",
        description="health-checked router over serving replicas")
    ap.add_argument("--replicas", type=int, default=FLAGS.fleet_replicas,
                    help="spawn a managed fleet of N demo-generate "
                         "replicas (serving/fleet.py)")
    ap.add_argument("--replica-arg", action="append", default=[],
                    help="extra argv appended to each managed replica "
                         "(repeatable)")
    ap.add_argument("--backends",
                    help="comma-separated replica base URLs (externally "
                         "managed; overrides --replicas)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=FLAGS.router_port)
    ap.add_argument("--poll-interval-s", type=float,
                    default=FLAGS.router_poll_interval_s)
    ap.add_argument("--unready-grace-s", type=float,
                    default=FLAGS.router_unready_grace_s)
    ap.add_argument("--eject-threshold", type=int,
                    default=FLAGS.router_eject_threshold)
    ap.add_argument("--eject-cooldown-s", type=float,
                    default=FLAGS.router_eject_cooldown_s)
    ap.add_argument("--retry-budget", type=int,
                    default=FLAGS.router_retry_budget)
    ap.add_argument("--hedge-ms", type=float, default=FLAGS.router_hedge_ms)
    ap.add_argument("--fault-spec", default=FLAGS.resilience_fault_spec,
                    help="deterministic fault plan (router.dispatch is "
                         "the router-layer point; chaos testing only)")
    ap.add_argument("--obs-trace",
                    type=lambda v: v.lower() in ("1", "true", "yes"),
                    default=FLAGS.obs_trace_enable,
                    help="per-request span tracing (obs/trace.py): "
                         "/debug/traces + traceparent propagation to "
                         "the replicas")
    ap.add_argument("--obs-trace-sample", type=float,
                    default=FLAGS.obs_trace_sample)
    ap.add_argument("--obs-trace-ring", type=int,
                    default=FLAGS.obs_trace_ring)
    ap.add_argument("--smoke", action="store_true",
                    help="fleet self-test (2 replicas, kill -9 one "
                         "mid-stream), one JSON line, exit")
    ap.add_argument("--smoke-disagg", action="store_true",
                    help="disaggregated-serving self-test (1 prefill + "
                         "1 decode replica, socket KV handoff at the "
                         "first token, analytic fallback, kill -9 of "
                         "the prefill replica), one JSON line, exit")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.replica_arg)
    if args.smoke_disagg:
        return _smoke_disagg(args.replica_arg)
    if args.fault_spec:
        faults.install_spec(args.fault_spec)
        logger.warning("fault injection ACTIVE: %s", args.fault_spec)
    if args.obs_trace:
        obstrace.enable(sample=args.obs_trace_sample,
                        capacity=args.obs_trace_ring, process="router")
    sup = None
    if args.backends:
        router = Router(replicas=[u.strip() for u in
                                  args.backends.split(",") if u.strip()],
                        poll_interval_s=args.poll_interval_s,
                        unready_grace_s=args.unready_grace_s,
                        eject_threshold=args.eject_threshold,
                        eject_cooldown_s=args.eject_cooldown_s,
                        retry_budget=args.retry_budget,
                        hedge_ms=args.hedge_ms)
    else:
        from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
        sup = ReplicaSupervisor(n_replicas=args.replicas,
                                extra_args=args.replica_arg).start()
        router = Router(supervisor=sup,
                        poll_interval_s=args.poll_interval_s,
                        unready_grace_s=args.unready_grace_s,
                        eject_threshold=args.eject_threshold,
                        eject_cooldown_s=args.eject_cooldown_s,
                        retry_budget=args.retry_budget,
                        hedge_ms=args.hedge_ms)
    router.start(args.host, args.port)     # serves on a daemon thread
    stop = threading.Event()

    def _drain(signum, frame):
        logger.info("SIGTERM: stopping router%s",
                    " + fleet" if sup is not None else "")
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    except ValueError:
        pass
    try:
        stop.wait()
    finally:
        router.close()
        if sup is not None:
            sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
