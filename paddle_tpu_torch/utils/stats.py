"""Timer / stat registry and a latency histogram
(``paddle_tpu/utils/stats.py``; reference paddle/utils/Stat.h:70-241).

``global_stats.get(name)`` is a host wall-clock ``Stat`` (total, count,
max, avg) that the trainer feeds, as JAX's does: ``h2d_wait`` is the
time each step waited for its device-ready feed.  ``timer(name)`` is the
reference's ``REGISTER_TIMER``: a ``with`` block timed into that stat;
``print_all_stats`` logs every stat that counted.  ``Histogram`` is the
``keep="last"`` ring of JAX's, with its injectable clock.
"""

import contextlib
import threading
import time
from collections import OrderedDict

import numpy as np


class Stat:
    __slots__ = ("name", "total", "count", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.max = 0.0
        self._lock = threading.Lock()

    def add(self, seconds: float):
        with self._lock:
            self.total += seconds
            self.count += 1
            if seconds > self.max:
                self.max = seconds

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self):
        with self._lock:
            self.total = 0.0
            self.count = 0
            self.max = 0.0

    def __repr__(self):
        return (f"Stat({self.name}: total={self.total * 1e3:.2f}ms "
                f"avg={self.avg * 1e3:.3f}ms max={self.max * 1e3:.3f}ms "
                f"count={self.count})")


class StatRegistry:
    def __init__(self):
        self._stats = OrderedDict()
        self._lock = threading.Lock()

    def get(self, name: str) -> Stat:
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = self._stats[name] = Stat(name)
            return stat

    def reset_all(self):
        for stat in list(self._stats.values()):
            stat.reset()

    def print_all(self, log=None):
        from paddle_tpu_torch.utils.logging import logger
        log = log or logger
        log.info("======= StatSet =======")
        for stat in self._stats.values():
            if stat.count:
                log.info("  %s", stat)

    def items(self):
        return list(self._stats.items())


global_stats = StatRegistry()


@contextlib.contextmanager
def timer(name: str, registry: StatRegistry = None):
    """``with timer("forwardBackward"): ...`` adds the block's wall time
    to the stat ``name`` (the reference's REGISTER_TIMER)."""
    stat = (registry or global_stats).get(name)
    start = time.perf_counter()
    try:
        yield stat
    finally:
        stat.add(time.perf_counter() - start)


def print_all_stats():
    global_stats.print_all()


class Histogram:
    """The most recent ``max_samples`` observations and their
    percentiles — a long-running server reports RECENT latency.

    clock: optional zero-arg monotonic clock.  When given, every sample
    is stamped at ``add`` and ``percentiles(qs, window_s=W)`` /
    ``recent_samples(W)`` read only the samples of the last W seconds of
    ``clock()`` — the SLO windows of the router's overload control and
    the autoscaler; a test injects a simulated clock."""

    def __init__(self, name, max_samples=10000, clock=None):
        self.name = name
        self.samples = []
        self.max_samples = max_samples
        self.count = 0          # total observed, including overwritten
        self.clock = clock
        self.times = [] if clock is not None else None

    def add(self, seconds):
        self.count += 1
        t = self.clock() if self.clock is not None else None
        if len(self.samples) < self.max_samples:
            self.samples.append(seconds)
            if self.times is not None:
                self.times.append(t)
        else:
            i = (self.count - 1) % self.max_samples
            self.samples[i] = seconds
            if self.times is not None:
                self.times[i] = t

    def recent_samples(self, window_s=None):
        """The retained samples inside the window (all of them when
        ``window_s`` is None), read in one pass: a caller asking both
        "is there a signal" and "what is its percentile" reads this once
        rather than racing two clock reads against the window's edge."""
        if window_s is None:
            return list(self.samples)
        if self.times is None:
            raise ValueError(f"Histogram {self.name!r} has no clock; "
                             "window_s needs Histogram(clock=...)")
        cutoff = self.clock() - float(window_s)
        return [s for s, t in zip(self.samples, self.times) if t >= cutoff]

    def percentiles(self, qs=(50, 90, 99), window_s=None):
        samples = self.recent_samples(window_s)
        if not samples:
            return {q: 0.0 for q in qs}
        arr = np.asarray(samples)
        return {q: float(np.percentile(arr, q)) for q in qs}
