"""Overlapped input pipeline: host batches -> device-resident feeds, N
ahead (``paddle_tpu/data/prefetch.py``; reference DataProvider.h:251's
DoubleBuffer thread).

A bounded background thread runs the feeder conversion AND the
host-to-device copy, so the trainer's loop dequeues feeds that are
already on the card.  On CUDA the producer copies on a stream of its
own and waits for that stream before it hands a feed over, so a feed
in the queue is complete; the consumer marks each delivered tensor as
used on its current stream (``record_stream``), so the caching
allocator cannot give the memory back to the producer's stream while a
step still reads it.  Every batch is a fresh copy: the prefetcher never
pools or reuses device buffers, and the producer drops its reference
once a batch is queued (JAX's donation discipline), which is one reason
``SGD.train(prefetch=N)`` is bit for bit ``prefetch=0``.

Exceptions raised by the source, the conversion or the placement
surface in the CONSUMER thread at its next ``__next__``; there is no
fallback to the synchronous path.  The fault point
``data.prefetch.h2d`` (``resilience/faults.py``) sits before each
placement, and the placement is the span ``data.h2d``
(``obs/trace.py``), as in JAX's producer; both are no-ops when off.  ``close()`` (or exhausting the
stream) joins the producer thread, and a prefetcher dropped without
``close()`` is stopped and drained by its GC finalizer.
"""

import contextlib
import queue as _queue
import threading
import time
import weakref

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, \
    SequenceBatch
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger

_END = object()


def _release(stop, q):
    """Stop the producer and drop the queued batches.  Module-level so a
    weakref.finalize can run it after the owning prefetcher is collected
    (no strong reference to it)."""
    stop.set()
    try:
        while True:
            q.get_nowait()
    except _queue.Empty:
        pass


def _bounded_put(q, stop, item):
    """A put that gives up once ``stop`` is set instead of blocking
    forever against a consumer that went away."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def _fill(source, convert, place, stream, stop, q):
    """Producer body.  Module-level (not a bound method) on purpose: a
    RUNNING thread holds its target, so a method target would keep the
    prefetcher alive and its GC finalizer from ever firing."""
    from paddle_tpu_torch.obs import trace as obstrace
    from paddle_tpu_torch.resilience import faults
    ctx = (lambda: torch.cuda.stream(stream)) if stream is not None \
        else contextlib.nullcontext
    try:
        for batch in source():
            if stop.is_set():
                return
            with ctx():
                feed = convert(batch) if convert else batch
                # an injected failure at the H2D boundary crosses to the
                # consumer like any real placement error
                faults.hit("data.prefetch.h2d")
                # the span times the copy's dispatch on this thread
                with obstrace.span("data.h2d", root=False):
                    feed = place(feed)
            if stream is not None:
                # the copy is complete before the feed is queued
                stream.synchronize()
            if not _bounded_put(q, stop, feed):
                return
            # the queue holds the only producer-side reference now
            del feed
    except BaseException as e:  # noqa: BLE001 — must cross threads
        _bounded_put(q, stop, _Failure(e))
    else:
        _bounded_put(q, stop, _END)


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _run_jobs(jobs, done, stop):
    """TransferWorker body; module-level for the same GC reason as
    ``_fill``."""
    while not stop.is_set():
        try:
            item = jobs.get(timeout=0.1)
        except _queue.Empty:
            continue
        if item is _END:
            return
        tag, fn = item
        try:
            out = fn()
        except BaseException as e:  # noqa: BLE001 — must cross threads
            out = _Failure(e)
        if not _bounded_put(done, stop, (tag, out)):
            return
        del out


class TransferWorker:
    """One bounded daemon thread running submitted zero-argument jobs in
    order, with the prefetcher's lifecycle (stop event, bounded puts, a
    ``_Failure`` crossing for what a job raised, GC finalizer).  Results
    come back from ``poll()`` tagged with the submitter's token (the
    serving host tier's KV restores reuse it)."""

    def __init__(self, name="paddle-tpu-transfer", depth=8):
        self._jobs = _queue.Queue()
        self._done = _queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_run_jobs, args=(self._jobs, self._done, self._stop),
            daemon=True, name=name)
        self._finalizer = weakref.finalize(self, _release,
                                           self._stop, self._jobs)
        self._thread.start()

    def submit(self, tag, fn):
        """Queue ``fn`` for the worker; its result comes back from
        ``poll()`` as ``(tag, result)``."""
        self._jobs.put((tag, fn))

    def poll(self, timeout=0.0):
        """The next completed job as ``(tag, result)`` (``result`` a
        ``_Failure`` if the job raised), or None when none completed
        within ``timeout``."""
        try:
            if timeout:
                return self._done.get(timeout=timeout)
            return self._done.get_nowait()
        except _queue.Empty:
            return None

    def close(self):
        """Stop the worker and join it; queued jobs and undelivered
        results are dropped.  Safe to call more than once."""
        _release(self._stop, self._jobs)
        _release(self._stop, self._done)
        self._finalizer.detach()
        self._jobs.put(_END)
        self._thread.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _to(tree, dev):
    """A feed tree with every tensor on ``dev`` (sequences keep their
    type; numpy arrays become tensors)."""
    if isinstance(tree, (SequenceBatch, NestedSequenceBatch)):
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return torch.as_tensor(tree).to(dev)


def device_placer(mesh=None, device=None):
    """A function placing a feed tree on ``device`` (the card unless
    "cpu").  A ``mesh`` (sharded placement) raises: sharding is ROADMAP
    A12."""
    if mesh is not None:
        raise ConfigError("device_placer(mesh=...): sharded placement is "
                          "not ported (ROADMAP A12)")
    dev = _device.resolve(device)

    def place(feed):
        return _to(feed, dev)
    place.device = dev
    return place


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class ShardedPrefetcher:
    """Bounded background producer of device-resident feeds.

    source: zero-argument callable returning an iterator of host batches
    (the reader contract).  convert: host batch -> feed (the feeder
    conversion); runs on the producer thread; None is the identity.
    place: feed -> device-resident feed, on the producer thread; None is
    ``device_placer()`` (the card).  depth: the most batches queued ahead
    of the consumer (one more may be in flight).

    ``wait_s`` sums the consumer's blocked time (the trainer's
    ``h2d_wait``), ``batches`` the batches delivered.  A context manager:
    ``close()`` on exit."""

    def __init__(self, source, depth=2, convert=None, place=None,
                 start=True):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self._place = place if place is not None else device_placer()
        dev = getattr(self._place, "device", None)
        stream = torch.cuda.Stream(dev) if dev is not None \
            and dev.type == "cuda" else None
        self._q = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._started = False
        self.wait_s = 0.0
        self.batches = 0
        self._thread = threading.Thread(
            target=_fill,
            args=(source, convert, self._place, stream, self._stop, self._q),
            daemon=True, name="paddle-tpu-prefetch")
        # a consumer that drops the iterator without close() must not
        # leave the producer running with ~depth+1 batches on the card
        self._finalizer = weakref.finalize(self, _release,
                                           self._stop, self._q)
        if start:
            self.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if not self._started:       # start=False: iterating starts it
            self.start()
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is _END:
            self._done = True
            self._thread.join()
            raise StopIteration
        if isinstance(item, _Failure):
            self._done = True
            self._thread.join()
            raise item.exc
        for t in _tensors(item):
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        self.batches += 1
        return item

    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self):
        """Stop the producer and join it; safe to call more than once.
        Queued (undelivered) batches are dropped."""
        self._done = True
        _release(self._stop, self._q)
        self._finalizer.detach()
        if self._started:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                logger.warning(
                    "ShardedPrefetcher.close(): producer thread still "
                    "alive after 30s (reader or device placement is "
                    "blocked); it is a daemon and ~depth batches of "
                    "device memory stay pinned until it unblocks")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
