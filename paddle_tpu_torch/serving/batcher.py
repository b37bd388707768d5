"""Dynamic micro-batching (``paddle_tpu/serving/batcher.py``):
concurrent single-sample requests -> bucketed ``InferenceEngine``
batches.

Callers submit single-sample feeds and get ``concurrent.futures.Future``s
back; ONE background thread drains a bounded queue, groups up to
``max_batch_size`` requests within a ``max_delay_ms`` window, and runs
them through the engine as one padded batch.

* admission control — the queue is bounded; a full queue rejects the
  submit with ``OverloadedError`` (HTTP 429).
* deadlines — a request whose deadline passed while queued fails with
  ``DeadlineExceededError`` without reaching the engine.
* error isolation — invalid feeds are rejected synchronously before the
  queue (``InvalidRequestError``); an engine failure fails only that
  batch's futures and the loop keeps serving; a client's ``cancel()``
  never kills the worker.
* graceful drain — ``close()`` stops admissions (``ShutdownError``) and
  finishes everything queued; ``close(drain=False)`` fails the queue.

The errors live in ``serving/errors.py`` and are re-exported here, as
JAX's module defines them.
"""

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.engine import stack_rows, tree_map
from paddle_tpu_torch.serving.errors import (BatchExecutionError,
                                             DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.utils.logging import logger

__all__ = ["Batcher", "BatchExecutionError", "DeadlineExceededError",
           "InvalidRequestError", "OverloadedError", "ShutdownError"]


class _Request:
    __slots__ = ("feed", "future", "deadline", "t_submit", "queue_span")

    def __init__(self, feed, deadline):
        self.feed = feed
        self.future = Future()
        self.deadline = deadline          # absolute perf_counter() or None
        self.t_submit = time.perf_counter()
        # async-seam span (obs/trace.py): submit() starts it AFTER the
        # request is actually enqueued (a rejected submit must not leak
        # a forever-active span); the worker ends it at batch pickup —
        # the queue wait made visible
        self.queue_span = obstrace.NULL

    def fail(self, exc):
        """Resolve with an exception, tolerating a client-side cancel that
        raced us — an InvalidStateError here must never kill the worker."""
        self.queue_span.end()       # idempotent; a request failed while
        #                             still queued must not leak its span
        try:
            self.future.set_exception(exc)
        except InvalidStateError:
            pass


class Batcher:
    """Bounded-queue dynamic batcher in front of an ``InferenceEngine``.

    max_batch_size: largest batch formed (default: the engine's top
    bucket).  max_delay_ms: how long the first request of a batch may wait
    for co-riders; 0 batches only what is already queued.  queue_size:
    admission bound.  default_deadline_ms: per-request deadline when the
    submit names none (None/0 = no deadline).
    """

    def __init__(self, engine, max_batch_size=None, max_delay_ms=5.0,
                 queue_size=256, default_deadline_ms=None, name=None):
        self.engine = engine
        self.metrics = engine.metrics
        self.max_batch_size = int(max_batch_size or engine.buckets[-1])
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.default_deadline_s = (float(default_deadline_ms) / 1e3
                                   if default_deadline_ms else None)
        if int(queue_size) < 1:
            # queue.Queue(0) would mean UNBOUNDED — silently disabling the
            # admission control this class exists to provide
            raise ValueError("queue_size must be >= 1")
        self._q = queue.Queue(maxsize=int(queue_size))
        self._depth_fn = self._q.qsize
        self.metrics.queue_depth_fns.append(self._depth_fn)
        self._closed = threading.Event()
        # makes {closed-check + enqueue} atomic against close(): without
        # it a submit could slip its request into the queue after the
        # drain finished, leaving its future unresolved forever
        self._admit_lock = threading.Lock()
        self.name = name or f"batcher[{engine.name}]"
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    # ------------------------------------------------------------ submit

    def submit(self, feed_row, deadline_ms=None):
        """Admit one single-sample feed (leaves WITHOUT a batch axis —
        the batcher stacks rows); returns a Future resolving to the
        per-row output pytree (numpy leaves).

        Raises synchronously: ``InvalidRequestError`` (spec mismatch —
        checked before queueing so a malformed request can never poison a
        batch), ``OverloadedError`` (queue full), ``ShutdownError``
        (draining)."""
        # fault point FIRST: an injected submit failure provably mutated
        # nothing, so retry_transient's idempotence guarantee holds
        faults.hit("batcher.submit")
        if self._closed.is_set():
            self.metrics.reject("shutdown")
            raise ShutdownError(f"{self.name} is draining; submit rejected")
        try:
            self.engine.validate(feed_row, batch=False)
        except InvalidRequestError:
            self.metrics.reject("invalid")
            raise
        dl_s = (float(deadline_ms) / 1e3 if deadline_ms
                else self.default_deadline_s)
        req = _Request(feed_row,
                       time.perf_counter() + dl_s if dl_s else None)
        # start the queue-wait span before the enqueue (the worker may
        # pull the request the instant it lands); the rejection paths
        # below end it so a refused submit leaks nothing
        # root=False: driven without an HTTP request span (bench drives,
        # embedded use) this must not mint a "request" for slowest()
        req.queue_span = obstrace.start_span("batcher.queue_wait",
                                             root=False)
        with self._admit_lock:
            if self._closed.is_set():   # close() raced the check above
                req.queue_span.end()
                self.metrics.reject("shutdown")
                raise ShutdownError(
                    f"{self.name} is draining; submit rejected")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                req.queue_span.end()
                self.metrics.reject("overload")
                raise OverloadedError(
                    f"{self.name}: queue full ({self._q.maxsize} waiting)") \
                    from None
        self.metrics.accepted()
        return req.future

    def infer_one(self, feed_row, timeout=None, deadline_ms=None):
        """submit() + block for the result (the HTTP handler's path)."""
        return self.submit(feed_row, deadline_ms=deadline_ms).result(timeout)

    # ------------------------------------------------------------ worker

    def _loop(self):
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            batch = [first]
            # batch formation window: from the FIRST rider's pickup, wait
            # up to max_delay for co-riders, but never once full
            t_close = time.perf_counter() + self.max_delay_s
            while len(batch) < self.max_batch_size:
                wait = t_close - time.perf_counter()
                # draining: take whatever is queued, never wait for more
                if self._closed.is_set():
                    wait = 0.0
                try:
                    batch.append(self._q.get(timeout=max(wait, 0.0))
                                 if wait > 0 else self._q.get_nowait())
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _run_batch(self, batch):
        now = time.perf_counter()
        live = []
        for r in batch:
            r.queue_span.end(batch_size=len(batch))
            if r.deadline is not None and now > r.deadline:
                self.metrics.reject("deadline")
                r.fail(DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{(now - r.t_submit) * 1e3:.1f}ms in queue"))
                continue
            # atomically move PENDING -> RUNNING: a client cancel() from
            # here on returns False, so set_result below cannot race it;
            # False means the future was already cancelled — drop it
            if not r.future.set_running_or_notify_cancel():
                continue
            live.append(r)
        if not live:
            return
        try:
            stacked = stack_rows([r.feed for r in live])
            # batch-assembly span: one per executed batch (the worker
            # thread has no request context; root=False keeps it out of
            # the slowest-requests table)
            with obstrace.span("batcher.batch", root=False, n=len(live)):
                out = self.engine.infer(stacked)    # host numpy leaves
        except Exception as e:    # noqa: BLE001 — isolate to THIS batch
            logger.warning("%s: batch of %d failed: %s: %s", self.name,
                           len(live), type(e).__name__, e)
            self.metrics.observe_error(len(live))
            for r in live:
                r.fail(BatchExecutionError(
                    f"batch execution failed: {type(e).__name__}: {e}"))
            return
        t_done = time.perf_counter()
        for i, r in enumerate(live):
            row = tree_map(lambda l, i=i: l[i], out)
            self.metrics.observe_response(t_done - r.t_submit)
            r.future.set_result(row)

    # ------------------------------------------------------------ shutdown

    def close(self, drain=True, timeout=30.0):
        """Stop admissions, then either finish the queue (drain=True) or
        fail queued requests with ``ShutdownError``.  Idempotent."""
        with self._admit_lock:      # no submit can race past this point
            self._closed.set()
        # stop contributing to a (possibly shared, longer-lived) metrics
        # object's queue depth — a closed batcher's queue is not backlog
        try:
            self.metrics.queue_depth_fns.remove(self._depth_fn)
        except ValueError:
            pass                    # already removed (idempotent close)
        if not drain:
            while True:
                try:
                    r = self._q.get_nowait()
                except queue.Empty:
                    break
                self.metrics.reject("shutdown")
                r.fail(ShutdownError("batcher closed without drain"))
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning("%s: worker did not drain within %.0fs",
                           self.name, timeout)
        # backstop: a request admitted in the instant between the worker's
        # final empty poll and its closed-check is still in the queue now
        # — fail it rather than strand its caller forever
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            self.metrics.reject("shutdown")
            r.fail(ShutdownError("batcher closed"))

    @property
    def closed(self):
        return self._closed.is_set()

    @property
    def ready(self):
        """Readiness (/readyz): accepting work AND the engine's ladder
        is warm (no request can pay a compile or hit a drain)."""
        return not self._closed.is_set() and self.engine.ready

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
