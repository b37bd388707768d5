"""Latency histogram (the ``keep="last"`` ring of
``paddle_tpu/utils/stats.Histogram``, without its injectable clock)."""

import numpy as np


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
