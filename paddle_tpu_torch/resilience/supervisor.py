"""Supervised recovery (``paddle_tpu/resilience/supervisor.py``):
watchdog, circuit breaker, bounded retry, decode-slot re-seating.

* ``Supervisor.run_step(engine)`` — a per-step WATCHDOG: with
  ``step_deadline_s`` set, the decode step runs on a persistent worker
  thread and a step that neither returns nor raises within the deadline
  trips ``WatchdogTimeout``.  The hung thread cannot be killed, but the
  engine's epoch guard (``DecodeEngine.reset`` bumps an epoch; ``step``,
  ``advance`` and ``poll_restores`` refuse to commit across it) keeps a
  late finisher from writing into the rebuilt cache.

* ``Supervisor.reprefill(engine, items)`` — SLOT RECOVERY: interrupted
  requests re-seat through ``DecodeEngine.seat_prefilled`` from
  ``prompt + tokens-so-far`` (the ladder re-prefills the longest covered
  prefix; the chunked engine feeds the whole context as chunks) and the
  remainder is teacher-forced through the step with its emissions
  swallowed, so a recovered greedy stream continues unchanged.

* ``CircuitBreaker`` — ``threshold`` CONSECUTIVE step failures open it:
  submits shed fast (HTTP 503 + ``Retry-After``).  After ``cooldown_s``
  it goes half-open and admits ONE probe; the next step success closes
  it, another failure re-opens it.

* ``retry_transient(fn)`` — bounded retry with exponential backoff and
  jitter drawn from ``random.Random(seed)`` (the same seed gives JAX's
  delays) for ``faults.TransientError``; wrap only idempotent calls (the
  submit fault point fires before any queue mutation).

``Supervisor`` holds policy; the ``GenerationBatcher`` owns the slot
bookkeeping and the metrics.
"""

import queue
import random
import threading
import time

import numpy as np

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.resilience.faults import TransientError
from paddle_tpu_torch.utils.logging import logger


class WatchdogTimeout(RuntimeError):
    """The supervised device step neither returned nor raised within
    the deadline — treated like a step failure (recover + rebuild)."""


class BreakerOpenError(RuntimeError):
    """The circuit breaker is shedding load (HTTP 503); retry after
    ``retry_after_s``."""

    def __init__(self, msg, retry_after_s=1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """closed -> (threshold consecutive failures) -> open -> (cooldown)
    -> half_open -> one probe -> closed | open.  Thread-safe; all state
    is host-side counters, so an always-closed breaker costs nothing."""

    def __init__(self, threshold=5, cooldown_s=5.0, clock=None):
        if int(threshold) < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        # injectable monotonic clock (default real): cooldown tests run
        # on a simulated clock instead of sleeping the cooldown out
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._failures = 0
        self._state = "closed"
        self._opened_at = 0.0
        self._probe_out = False
        self._probe_at = 0.0
        self.opened_total = 0       # times the breaker tripped open

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def _state_locked(self):
        if self._state == "open" and not self._probe_out \
                and self._clock() - self._opened_at >= self.cooldown_s:
            self._state = "half_open"
        return self._state

    def record_failure(self):
        """One step failure; returns True when this one OPENED the
        breaker (the transition, for logging/metrics)."""
        with self._lock:
            self._failures += 1
            self._probe_out = False
            if self._state_locked() == "half_open":
                # the probe failed: straight back to open, fresh
                # cooldown.  This IS a fresh open transition — counting
                # (and reporting) it keeps a flapping
                # open/half-open/open node visible in breaker_open_total
                # instead of looking like one long-ago blip.
                self._state = "open"
                self._opened_at = self._clock()
                self.opened_total += 1
                return True
            if self._state == "closed" and self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self.opened_total += 1
                return True
            return False

    def record_success(self):
        """A healthy step.  Closes from half-open (the probe — or any
        post-cooldown success — proved the engine recovered).  From OPEN
        it only resets the failure streak: in-flight recovered work
        stepping fine must not bypass the cooldown on a flapping engine
        (the documented open -> cooldown -> half-open -> close path)."""
        with self._lock:
            self._failures = 0
            st = self._state_locked()
            if st == "half_open":
                self._probe_out = False
                self._state = "closed"

    def release_probe(self):
        """Hand an unused half-open probe slot back (the probing request
        failed synchronously before it could ever reach a step)."""
        with self._lock:
            self._probe_out = False

    def seconds_until_probe(self):
        """Read-only: how long until the next probe could be admitted
        (0 when closed) — the /readyz Retry-After source.  Never
        consumes the probe slot."""
        with self._lock:
            if self._state_locked() == "closed":
                return 0.0
            return max(0.05, self.cooldown_s
                       - (self._clock() - self._opened_at))

    def admit(self):
        """Admission check: (True, None) to admit; (False, retry_after_s)
        to shed.  In half-open state exactly ONE caller gets the probe
        slot; the rest shed until the probe resolves."""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True, None
            now = self._clock()
            # half-open: one probe per cooldown window.  A probe that
            # never resolves through a step (e.g. it finished at
            # prefill) must not wedge admissions forever — after a
            # further cooldown a fresh probe is handed out.
            if st == "half_open" and (
                    not self._probe_out
                    or now - self._probe_at >= self.cooldown_s):
                self._probe_out = True
                self._probe_at = now
                return True, None
            remain = max(0.0, self.cooldown_s - (now - self._opened_at))
            return False, max(remain, 0.05)


def retry_transient(fn, budget=3, base_delay_s=0.01, max_delay_s=0.5,
                    seed=None, on_retry=None):
    """Call ``fn()``; on ``TransientError`` retry up to ``budget`` times
    with exponential backoff (``base_delay_s * 2**k``, capped) plus
    full jitter from a seeded stream (deterministic replays under test;
    de-synchronized thundering herds in production).  Non-transient
    exceptions propagate immediately.  ``on_retry(attempt, exc)`` is the
    metrics hook.  IDEMPOTENCE: only wrap calls whose failed attempts
    left no state behind (the batcher submit fault points fire before
    any queue mutation)."""
    rng = random.Random(seed)
    attempt = 0
    while True:
        try:
            return fn()
        except TransientError as e:
            attempt += 1
            if attempt > budget:
                raise
            delay = min(base_delay_s * (2 ** (attempt - 1)), max_delay_s)
            delay *= rng.random()
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)


class Supervisor:
    """Per-engine supervision policy for a ``GenerationBatcher``.

    step_deadline_s: watchdog deadline for one decode step (None = off,
    the step runs inline with zero overhead).  breaker_threshold /
    breaker_cooldown_s: circuit-breaker tuning.
    max_request_recoveries: how many times ONE request may be re-
    prefilled before it is failed (bounds the work a permanently
    poisoned step can burn).
    """

    def __init__(self, step_deadline_s=None, breaker_threshold=5,
                 breaker_cooldown_s=5.0, max_request_recoveries=5):
        self.step_deadline_s = (float(step_deadline_s)
                                if step_deadline_s else None)
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown_s)
        self.max_request_recoveries = int(max_request_recoveries)
        self.watchdog_trips = 0
        # persistent supervised-step worker (lazy): one long-lived thread
        # serves every deadline-guarded step — the per-token hot path
        # pays a queue handoff, not a thread create/teardown.  A worker
        # wedged by a hung step is abandoned (told to exit once it
        # unwedges) and replaced.
        self._worker = None

    # ------------------------------------------------------------ watchdog

    def _step_worker(self):
        if self._worker is None or not self._worker[0].is_alive():
            inq, outq = queue.Queue(), queue.Queue()

            def loop():
                while True:
                    eng = inq.get()
                    if eng is None:     # abandoned after a timeout: exit
                        return
                    try:
                        outq.put(("r", eng.step()))
                    except BaseException as e:   # noqa: BLE001 — crosses
                        outq.put(("e", e))       # threads

            t = threading.Thread(target=loop, daemon=True,
                                 name="supervised-decode-step")
            t.start()
            self._worker = (t, inq, outq)
        return self._worker

    def run_step(self, engine):
        """One supervised decode step.  Without a deadline this is a plain
        call; with one, the step runs on the persistent worker thread and
        a deadline miss raises ``WatchdogTimeout`` (the wedged worker is
        abandoned and replaced on the next step).  A late finisher is
        harmless: the engine's epoch guard discards its commit after the
        recovery path resets the cache."""
        if self.step_deadline_s is None:
            return engine.step()
        _t, inq, outq = self._step_worker()
        inq.put(engine)
        try:
            kind, val = outq.get(timeout=self.step_deadline_s)
        except queue.Empty:
            self.watchdog_trips += 1
            inq.put(None)       # exit once the hung step unwedges
            self._worker = None
            obstrace.instant("supervisor.watchdog_trip",
                             deadline_s=self.step_deadline_s)
            logger.warning("watchdog: decode step exceeded %.3fs deadline; "
                           "abandoning it and rebuilding",
                           self.step_deadline_s)
            raise WatchdogTimeout(
                f"decode step exceeded the {self.step_deadline_s:.3f}s "
                "deadline") from None
        if kind == "e":
            raise val
        return val

    # ------------------------------------------------------------ recovery

    def reprefill(self, engine, items):
        """Rebuild interrupted requests' slots on a freshly reset
        engine.  ``items`` is a list of ``(prompt, tokens)``; for each,
        the lost cache held K/V for ``full[0:R]`` with the last delivered
        token armed at position R, where ``full = prompt + tokens`` and
        ``R = len(full) - 1``.  On the ladder, the longest prefix the
        ladder covers re-prefills (same-bucket victims as ONE batch) and
        seats; the remainder is teacher-forced through the step, each
        re-derived emission swallowed by the batcher (the ``replay_feed``
        returned here).  On a chunked engine the whole context is the
        feed, drained up to K lanes a step.  Greedy decode is
        deterministic, so after the feed drains each slot is its
        pre-failure state.  Returns a list aligned with ``items``:
        ``(slot, replay_feed)`` per recovered request, or the exception
        that failed it.  The mechanics are ``DecodeEngine.
        seat_prefilled``'s, shared with continuation ``replay``, paged
        prefix-cache admission and pool-pressure re-seating."""
        with obstrace.span("supervisor.reprefill", root=False,
                           n=len(items)):
            return engine.seat_prefilled(
                [np.concatenate([np.asarray(prompt, np.int32),
                                 np.asarray(tokens, np.int32)])
                 for prompt, tokens in items])
