"""Timer / stat registry and a latency histogram
(``paddle_tpu/utils/stats.py``; reference paddle/utils/Stat.h:70-241).

``global_stats.get(name)`` is a host wall-clock ``Stat`` (total, count,
max, avg) that the trainer feeds, as JAX's does: ``h2d_wait`` is the
time each step waited for its device-ready feed.  ``Histogram`` is the
``keep="last"`` ring of JAX's, without its injectable clock.
"""

import threading
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


global_stats = StatRegistry()


class Histogram:
    """The most recent ``max_samples`` observations and their
    percentiles — a long-running server reports RECENT latency."""

    def __init__(self, name, max_samples=10000):
        self.name = name
        self.samples = []
        self.max_samples = max_samples
        self.count = 0          # total observed, including overwritten

    def add(self, seconds):
        self.count += 1
        if len(self.samples) < self.max_samples:
            self.samples.append(seconds)
        else:
            self.samples[(self.count - 1) % self.max_samples] = seconds

    def percentiles(self, qs=(50, 90, 99)):
        if not self.samples:
            return {q: 0.0 for q in qs}
        arr = np.asarray(self.samples)
        return {q: float(np.percentile(arr, q)) for q in qs}
