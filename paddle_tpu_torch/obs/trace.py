"""End-to-end request tracing: span recorder, context propagation,
Chrome-trace export (``paddle_tpu/obs/trace.py``, copied JAX-free).

Per-request SPANS, propagated across processes (W3C-traceparent style)
and exported as Chrome trace-event JSON: the server's request span, the
batcher's queue wait, prefill batches and slot lifetimes, the paged KV
pool's seat / fork / preempt instants, the trainer's steps, the
prefetcher's host-to-device copies and checkpoint writes.

Discipline (shared with ``resilience/faults.py``):

* strictly HOST-side: a span times the host's dispatch of the work it
  wraps, as JAX's do under async dispatch.  No span synchronizes the
  card, so tracing changes neither what the card runs nor when;
* near-zero cost when disabled (the default): every hook is one global
  read plus an ``is None`` test returning the ``NULL`` span singleton —
  no allocation, no lock, no contextvar touch;
* deterministic head sampling keyed on a hash of the trace_id
  (``obs_trace_sample``): every process in a distributed request derives
  the SAME keep/drop verdict from the propagated id, so a sampled trace
  is complete or absent, never partial.

Core surface:

* ``enable(sample=, capacity=, process=)`` / ``disable()`` — install /
  remove the process-wide ``Tracer`` (a bounded ring of completed spans;
  the oldest fall off, a long-running server holds RECENT traces).
* ``span(name, **attrs)`` — context manager: starts a span parented to
  the context-local current span (or a fresh root), makes it current for
  the ``with`` body, records it on exit.
* ``start_span`` / ``Span.end`` — the explicit pair for ASYNC seams
  (queue waits, slot lifetimes, futures) where begin and end live on
  different threads; these never touch the context variable.
* ``extract(header)`` / ``inject(headers)`` — traceparent propagation
  (``00-<trace_id>-<span_id>-01``): the server extracts an incoming
  header and continues its trace.
* ``snapshot()`` / ``debug_payload()`` — the ``/debug/traces`` JSON.
* ``chrome_trace(spans)`` / ``dump_chrome_trace(path, spans)`` — valid
  Chrome trace-event JSON (loadable in Perfetto): processes by name,
  tracks = decode slots.
* ``slowest(n)`` — trace_ids of the worst recent wall/TTFT requests, so
  the tail the percentiles report becomes a trace you can open.
"""

import collections
import contextvars
import json
import os
import threading
import time
import zlib

# the process-wide tracer; None (the default) makes every hook a no-op
_tracer = None

# context-local (trace_id, span_id) of the innermost active span() —
# per-thread AND per-async-context, so concurrent HTTP handler threads
# never cross their traces
_CTX = contextvars.ContextVar("paddle_tpu_torch_trace_ctx", default=None)

_TRACEPARENT_VERSION = "00"


def new_trace_id():
    return os.urandom(16).hex()


def new_span_id():
    return os.urandom(8).hex()


def _hash01(trace_id):
    """trace_id -> [0, 1): the deterministic head-sampling key.  Every
    process hashing the same propagated id reaches the same verdict."""
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 2**32


class _NullSpan:
    """The disabled-path singleton: every method is a no-op and every
    derived id is empty.  Identity-comparable (``span is NULL``) so the
    strict-no-op test can pin that the disabled path allocates nothing."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    def end(self, **attrs):
        return self


NULL = _NullSpan()


class Span:
    """One timed operation.  ``recording=False`` spans (head-sampling
    drop) still carry ids — propagation and response echo stay coherent
    on unsampled traces — but never reach the ring."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "t_end", "attrs", "events", "recording", "_token")

    def __init__(self, name, trace_id, parent_id, recording, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.t_start = time.time()
        self.t_end = None
        self.attrs = attrs
        self.events = []
        self.recording = recording
        self._token = None

    # ---- context-manager protocol: span() parents the with-body ----

    def __enter__(self):
        self._token = _CTX.set((self.trace_id, self.span_id))
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self.end()
        return False

    # ---- mutation (all no-ops on a non-recording span) ----

    def set(self, **attrs):
        if self.recording:
            self.attrs.update(attrs)
        return self

    def event(self, name, **attrs):
        """A timestamped point event inside this span (TTFT, a recovery
        re-prefill, a failover leg...)."""
        if self.recording:
            self.events.append({"t": time.time(), "name": name,
                                **({"attrs": attrs} if attrs else {})})
        return self

    def end(self, **attrs):
        if not self.recording:
            return self
        t = _tracer
        if t is None:                   # tracer torn down mid-flight
            self.t_end = self.t_end or time.time()
            return self
        # claim-the-end and ring insertion are ONE atomic section: the
        # async-seam contract allows double-end from different threads
        # (an owner racing a cleanup path), and a span must never reach
        # the ring twice
        with t._lock:
            if self.t_end is not None:  # idempotent (e.g. a request
                return self             # resolved through two paths)
            if attrs:
                self.attrs.update(attrs)
            self.t_end = time.time()
            t._active.pop(self.span_id, None)
            if len(t._done) == t._done.maxlen:
                t.dropped_total += 1
            t._done.append(self)
        return self

    def to_dict(self, process):
        # may run on the /debug/traces thread while the owning request
        # thread is still mutating an ACTIVE span.  dict(d)/list(l) are
        # single C-level copies (atomic under the GIL), event records are
        # appended whole and never mutated, and attrs values are
        # scalars — so the copy below is a coherent point-in-time view
        # without a per-span lock on the hot path.
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "process": process,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class Tracer:
    """Bounded ring buffer of completed spans + the live-span registry
    (in-flight spans show in snapshots with ``t_end: null`` — a replica
    about to be killed still shows the request it was serving)."""

    def __init__(self, sample=1.0, capacity=4096, process=None):
        if int(capacity) < 1:
            raise ValueError("obs_trace_ring must be >= 1")
        self.sample = float(sample)
        self.capacity = int(capacity)
        self.process = process or f"pid:{os.getpid()}"
        self._lock = threading.Lock()
        self._done = collections.deque(maxlen=self.capacity)
        self._active = {}
        self.started_total = 0
        self.dropped_total = 0      # ring overwrites (oldest span lost)

    def sampled(self, trace_id):
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return _hash01(trace_id) < self.sample

    def _start(self, span):
        with self._lock:
            self.started_total += 1
            self._active[span.span_id] = span

    def snapshot(self, include_active=True):
        """All held spans as dicts (completed ring + in-flight)."""
        with self._lock:
            spans = [s.to_dict(self.process) for s in self._done]
            if include_active:
                spans += [s.to_dict(self.process)
                          for s in self._active.values()]
        return spans

    def slowest(self, n=5):
        """The worst recent requests by wall time and by TTFT:
        ``{"wall": [...], "ttft": [...]}``, each entry carrying the
        trace_id — the percentiles' tail, openable as a trace."""
        with self._lock:
            roots = [s for s in self._done if s.attrs.get("root")]
        rows = []
        for s in roots:
            ttft = s.attrs.get("ttft_ms")
            if ttft is None:
                first = next((e for e in s.events
                              if e["name"] == "first_token"), None)
                if first is not None:
                    ttft = round((first["t"] - s.t_start) * 1e3, 3)
            rows.append({
                "trace_id": s.trace_id,
                "name": s.name,
                "route": s.attrs.get("route"),
                "t_start": s.t_start,
                "wall_ms": round((s.t_end - s.t_start) * 1e3, 3),
                "ttft_ms": ttft,
            })
        by_wall = sorted(rows, key=lambda r: -r["wall_ms"])[:n]
        by_ttft = sorted((r for r in rows if r["ttft_ms"] is not None),
                         key=lambda r: -r["ttft_ms"])[:n]
        return {"wall": by_wall, "ttft": by_ttft}


# ------------------------------------------------------------ module API


def enable(sample=None, capacity=None, process=None):
    """Install a process-wide ``Tracer`` (defaults from utils/flags.py
    ``obs_trace_*``); returns it.  Idempotent re-enable replaces the
    tracer (fresh ring)."""
    global _tracer
    if sample is None or capacity is None:
        from paddle_tpu_torch.utils.flags import FLAGS
        if sample is None:
            sample = FLAGS.obs_trace_sample
        if capacity is None:
            capacity = FLAGS.obs_trace_ring
    _tracer = Tracer(sample=sample, capacity=capacity, process=process)
    return _tracer


def disable():
    global _tracer
    _tracer = None


def enabled():
    return _tracer is not None


def get_tracer():
    return _tracer


def set_process(name):
    """Rename the tracer's process label (a replica learns its bound
    port after enable())."""
    t = _tracer
    if t is not None:
        t.process = str(name)


def current():
    """The context-local (trace_id, span_id) pair, or None."""
    return _CTX.get()


def current_trace_id():
    ctx = _CTX.get()
    return ctx[0] if ctx else ""


def _make_span(name, ctx, new_trace, attrs):
    """Shared constructor behind span()/start_span().  The hot disabled
    path returns the NULL singleton before touching anything else."""
    t = _tracer
    if t is None:
        return NULL
    parent_id = None
    if ctx is None and not new_trace:
        ctx = _CTX.get()
    if ctx is not None:
        trace_id, parent_id = ctx
    else:
        trace_id = new_trace_id()
        attrs.setdefault("root", True)
    span = Span(name, trace_id, parent_id, t.sampled(trace_id), attrs)
    if span.recording:
        t._start(span)
    return span


def span(name, ctx=None, new_trace=False, **attrs):
    """Context-manager span: parents to ``ctx`` (an explicit
    ``(trace_id, span_id)``), else to the context-local current span,
    else starts a new root trace (``new_trace=True`` skips the ambient
    context and forces a fresh one).  The with-body sees it as current.
    An attr ``root=True`` marks a request root for ``slowest()``
    (auto-set when a fresh trace starts here)."""
    return _make_span(name, ctx, new_trace, attrs)


def start_span(name, ctx=None, **attrs):
    """Async-seam span: like ``span()`` but never touches the context
    variable — begin here, carry the object across threads/futures, and
    ``.end()`` it where the operation really finishes."""
    return _make_span(name, ctx, False, attrs)


def instant(name, ctx=None, **attrs):
    """Zero-duration marker span (a CoW fork, a watchdog trip).  Never
    counts as a request root for ``slowest()``."""
    attrs.setdefault("root", False)
    s = _make_span(name, ctx, False, attrs)
    s.end()
    return s


# ------------------------------------------------------------ propagation


def extract(header):
    """Parse a traceparent-style header into a ``(trace_id, span_id)``
    context, or None when absent/malformed (a malformed header starts a
    fresh trace rather than failing the request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 3:
        return None
    _ver, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


def inject(headers=None, ctx=None):
    """Add the traceparent header for ``ctx`` (default: the current
    context) into ``headers`` (created if None); returns the dict
    unchanged when there is nothing to propagate."""
    headers = headers if headers is not None else {}
    if ctx is None:
        ctx = _CTX.get()
    if ctx is not None:
        headers["traceparent"] = (f"{_TRACEPARENT_VERSION}-{ctx[0]}-"
                                  f"{ctx[1]}-01")
    return headers


# ------------------------------------------------------------ export


def snapshot(include_active=True):
    t = _tracer
    return t.snapshot(include_active) if t is not None else []


def slowest(n=5):
    t = _tracer
    return t.slowest(n) if t is not None else {"wall": [], "ttft": []}


def debug_payload(n_slowest=5):
    """The ``/debug/traces`` JSON body (``serving/server.py``'s GET)."""
    t = _tracer
    if t is None:
        return {"enabled": False, "process": None, "spans": [],
                "slowest": {"wall": [], "ttft": []}}
    return {
        "enabled": True,
        "process": t.process,
        "sample": t.sample,
        "capacity": t.capacity,
        "started_total": t.started_total,
        "dropped_total": t.dropped_total,
        "spans": t.snapshot(),
        "slowest": t.slowest(n_slowest),
    }


def chrome_trace(spans=None):
    """Span dicts -> a Chrome trace-event JSON object (the
    ``chrome://tracing`` / Perfetto format): one "X" complete event per
    span, "i" instants for span events, and metadata naming processes
    (router / each replica) and tracks (decode slots).  ``spans`` may be
    a MERGED list from several processes' ``/debug/traces`` — that is
    the point: one file shows the whole fleet on one timeline."""
    if spans is None:
        spans = snapshot()
    pids = {}
    tid_names = {}          # (pid, tid) -> track name
    events = []
    for s in spans:
        proc = s.get("process") or "unknown"
        pid = pids.setdefault(proc, len(pids) + 1)
        slot = s.get("attrs", {}).get("slot")
        if slot is not None:
            tid = 100 + int(slot)
            tid_names[(pid, tid)] = f"slot {int(slot)}"
        else:
            tid = 1
            tid_names.setdefault((pid, tid), "host")
        t0 = s["t_start"]
        t1 = s["t_end"] if s["t_end"] is not None else t0
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"]}
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        args.update(s.get("attrs", {}))
        events.append({
            "name": s["name"], "cat": "obs", "ph": "X",
            "ts": round(t0 * 1e6, 3),
            "dur": round(max(0.0, t1 - t0) * 1e6, 3),
            "pid": pid, "tid": tid, "args": args,
        })
        for ev in s.get("events", ()):
            events.append({
                "name": ev["name"], "cat": "obs", "ph": "i", "s": "t",
                "ts": round(ev["t"] * 1e6, 3), "pid": pid, "tid": tid,
                "args": dict(ev.get("attrs", {}),
                             trace_id=s["trace_id"]),
            })
    meta = []
    for proc, pid in pids.items():
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": proc}})
    for (pid, tid), label in tid_names.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": label}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path, spans=None):
    """Write ``chrome_trace(spans)`` to ``path``; returns the object."""
    obj = chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj
