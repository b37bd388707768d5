"""Bucketed inference engine (``paddle_tpu/serving/engine.py``): the
execution half of the ``/v1/infer`` plane.

Every request batch is padded up to the nearest batch-size bucket of a
fixed ladder, run through the model's forward at that bucket, and its
real rows sliced back; a batch above the top bucket is served in chunks
of the top bucket.  The forward is applied per row, so padding and
chunking change nothing about any real row's result (pad rows replicate
the last real row, which keeps them in range for any model — zeros can
be out of vocabulary for an id feed).

The forward is an in-process ``trainer.Inferencer``'s
(``from_inferencer`` / ``from_topology``): its parameters, state,
quantization and dtype policy, in test mode, on its device (the card
unless "cpu"); on the card its layers launch the port's kernels (an
``lstmemory`` the fused LSTM forward).  Where JAX compiles one XLA
executable per bucket, the port runs eagerly: ``trace_count`` counts the
bucket shapes run for the first time, ``warmup()`` runs every bucket
once on zeros (the first call pays the kernels' load and the allocator's
growth), and steady-state serving adds none.

JAX-only stages: ``from_artifact`` / ``from_artifacts`` load exported
StableHLO (ROADMAP A11, ``export.py``) and ``lower()`` feeds XLA's cost
model (ROADMAP A13, ``perf/``); both raise ``ConfigError`` here.
"""

import threading
import time
import typing

import numpy as np
import torch

from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.errors import InvalidRequestError
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.stats import timer

DEFAULT_BUCKETS = (1, 4, 16, 64)

_RECORDS = (SequenceBatch, NestedSequenceBatch)


class ShapeDtype(typing.NamedTuple):
    """One feed leaf's shape and numpy dtype (``jax.ShapeDtypeStruct``'s
    role in ``bucket_spec``)."""
    shape: tuple
    dtype: np.dtype


# ------------------------------------------------------------ feed trees
# A feed is a dict of leaves (numpy arrays, tensors, or a SequenceBatch /
# NestedSequenceBatch of them); the structure is compared and rebuilt the
# way JAX's pytrees are.


def _flatten(tree):
    """(leaves, structure): dict keys sorted, records by class."""
    if isinstance(tree, ShapeDtype):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in subs for x in leaves],
                ("dict", tuple(keys), tuple(s for _, s in subs)))
    if isinstance(tree, _RECORDS):
        subs = [_flatten(v) for v in tree]
        return ([x for leaves, _ in subs for x in leaves],
                (type(tree), tuple(s for _, s in subs)))
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v) for v in tree]
        return ([x for leaves, _ in subs for x in leaves],
                ("list", tuple(s for _, s in subs)))
    return [tree], None


def _unflatten(struct, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if s[0] == "dict":
            return {k: build(sub) for k, sub in zip(s[1], s[2])}
        if s[0] == "list":
            return [build(sub) for sub in s[1]]
        return s[0](*[build(sub) for sub in s[1]])
    return build(struct)


def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over feed trees of one structure."""
    leaves, struct = _flatten(tree)
    others = [_flatten(r)[0] for r in rest]
    return _unflatten(struct, [fn(*xs) for xs in zip(leaves, *others)])


def _np_leaf(leaf):
    if isinstance(leaf, np.ndarray):
        return leaf
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _pad_rows(tree, n):
    """Pad every leaf's leading (batch) axis up to n by replicating the
    last real row."""
    def pad(leaf):
        leaf = _np_leaf(leaf)
        b = leaf.shape[0]
        if b == n:
            return leaf
        reps = np.repeat(leaf[-1:], n - b, axis=0)
        return np.concatenate([leaf, reps], axis=0)
    return tree_map(pad, tree)


def _concat_rows(trees):
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *ls: np.concatenate(ls, axis=0), *trees)


def stack_rows(rows):
    """Single-sample feeds (no batch axis) -> one batch feed."""
    return tree_map(lambda *ls: np.stack([_np_leaf(x) for x in ls], axis=0),
                    *rows)


class InferenceEngine:
    """Dynamic-batching execution engine over a bucket ladder.

    Build with ``from_inferencer(inferencer, feed_spec, buckets=...)`` or
    ``from_topology(output_layer, parameters, feed_spec, ...)``.
    ``feed_spec``: one feed dict whose leaves carry a LEADING batch axis
    (any size; replaced per bucket) — example arrays or tensors,
    ``ShapeDtype``s, or SequenceBatch-wrapped versions.  ``warm=True``
    runs every bucket before traffic; ``warm=False`` runs each on first
    use."""

    def __init__(self, *, forward=None, feed_spec=None,
                 buckets=DEFAULT_BUCKETS, warm=True, name="model",
                 metrics=None, device=None):
        self.name = name
        self.metrics = metrics or ServingMetrics()
        self._lock = threading.Lock()   # the warm-bucket table
        self._compiled = set()          # buckets run at least once
        self._trace_count = 0
        if forward is None:
            raise ConfigError("InferenceEngine needs a forward (use the "
                              "from_* factories)")
        self._forward = forward
        self.device = torch.device(device or "cpu")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ConfigError(f"bad bucket ladder {buckets!r}")
        if feed_spec is None:
            raise ConfigError("InferenceEngine needs a feed_spec")
        self._set_row_spec(feed_spec)
        if warm:
            self.warmup()

    # ------------------------------------------------------------ factories

    @classmethod
    def from_inferencer(cls, inferencer, feed_spec, buckets=DEFAULT_BUCKETS,
                        warm=True, name="model", metrics=None):
        """Wrap an in-process ``trainer.Inferencer`` (params, state,
        quantization and dtype policy already resolved there) in a bucket
        ladder on its device."""
        def forward(feed):
            return inferencer._fwd(inferencer._exec_params,
                                   inferencer.model_state, feed)
        return cls(forward=forward, feed_spec=feed_spec, buckets=buckets,
                   warm=warm, name=name, metrics=metrics,
                   device=inferencer.device)

    @classmethod
    def from_topology(cls, output_layer, parameters, feed_spec,
                      model_state=None, buckets=DEFAULT_BUCKETS, warm=True,
                      compute_dtype=None, quantize=None, name="model",
                      metrics=None, device=None):
        from paddle_tpu_torch.trainer.trainer import Inferencer
        inf = Inferencer(output_layer, parameters, model_state=model_state,
                         compute_dtype=compute_dtype, quantize=quantize,
                         device=device)
        return cls.from_inferencer(inf, feed_spec, buckets=buckets,
                                   warm=warm, name=name, metrics=metrics)

    @classmethod
    def from_artifact(cls, *args, **kw):
        raise ConfigError(
            "InferenceEngine.from_artifact loads exported StableHLO, a JAX "
            "stage the port has not taken (ROADMAP A11, export.py); serve "
            "an in-process model with from_inferencer / from_topology")

    @classmethod
    def from_artifacts(cls, *args, **kw):
        raise ConfigError(
            "InferenceEngine.from_artifacts loads an exported StableHLO "
            "ladder, a JAX stage the port has not taken (ROADMAP A11, "
            "export.py); serve an in-process model with from_inferencer / "
            "from_topology")

    # ------------------------------------------------------------ spec

    def _set_row_spec(self, feed_spec):
        """The per-row signature (structure + each leaf's trailing shape
        and dtype) that validation and ``bucket_spec`` use."""
        leaves, struct = _flatten(feed_spec)
        sig = []
        for leaf in leaves:
            shape = tuple(leaf.shape)
            if len(shape) < 1:
                raise ConfigError(
                    "feed_spec leaves need a leading batch axis; got a "
                    f"scalar {leaf!r}")
            sig.append((shape[1:], _np_dtype(leaf.dtype)))
        self._struct = struct
        self._row_sig = tuple(sig)

    def bucket_spec(self, bucket):
        """The feed tree of ``ShapeDtype``s for one bucket."""
        return _unflatten(self._struct,
                          [ShapeDtype((bucket,) + shape, dtype)
                           for shape, dtype in self._row_sig])

    def validate(self, feed, batch=True):
        """Shape/dtype-check a feed against the engine spec; raises
        ``InvalidRequestError``.  batch=True expects a leading batch axis
        (equal across leaves); batch=False bare per-row leaves.  Returns
        the batch size (1 for a row)."""
        try:
            leaves, struct = _flatten(feed)
        except Exception as e:    # noqa: BLE001 — unreadable input
            raise InvalidRequestError(f"unreadable feed: {e}") from e
        if struct != self._struct:
            raise InvalidRequestError(
                f"feed structure {struct} != engine spec {self._struct}")
        b = None
        for leaf, (shape, dtype) in zip(leaves, self._row_sig):
            a = _np_leaf(leaf)
            if batch:
                if a.ndim != len(shape) + 1 or tuple(a.shape[1:]) != shape:
                    raise InvalidRequestError(
                        f"leaf shape {a.shape} != [B]+{list(shape)}")
                if b is None:
                    b = a.shape[0]
                elif a.shape[0] != b:
                    raise InvalidRequestError(
                        f"inconsistent batch dims ({b} vs {a.shape[0]})")
            elif tuple(a.shape) != shape:
                raise InvalidRequestError(
                    f"row leaf shape {a.shape} != {list(shape)}")
            if np.dtype(a.dtype) != dtype:
                raise InvalidRequestError(
                    f"leaf dtype {a.dtype} != {dtype}")
        if batch and not b:
            raise InvalidRequestError("empty batch")
        return b if batch else 1

    # ------------------------------------------------------------ warm-up

    @property
    def trace_count(self):
        """Bucket shapes run for the first time (JAX: forward traces):
        one per bucket after warm-up, flat in steady state."""
        return self._trace_count

    @property
    def ready(self):
        """Readiness (/readyz): every ladder bucket has run once."""
        with self._lock:
            return all(b in self._compiled for b in self.buckets)

    def bucket_for(self, n):
        """Smallest bucket >= n, or None when n exceeds the ladder top."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def _first_run(self, bucket):
        with self._lock:
            if bucket not in self._compiled:
                self._compiled.add(bucket)
                self._trace_count += 1
                logger.info("serving[%s]: bucket %d first run", self.name,
                            bucket)

    def _run(self, feed):
        """The forward on a padded feed: host numpy in, host numpy
        out."""
        dev = self.device
        feed = tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                        .to(dev), feed)
        with torch.no_grad():
            out = self._forward(feed)
        return tree_map(_np_leaf, out)

    def warmup(self):
        """Run every ladder bucket once on zeros before traffic.  Returns
        the number of buckets run for the first time."""
        n_new = 0
        for b in self.buckets:
            if b in self._compiled:
                continue
            n_new += 1
            zeros = tree_map(lambda s: np.zeros(s.shape, s.dtype),
                             self.bucket_spec(b))
            self._first_run(b)
            self._run(zeros)
        if n_new:
            logger.info("serving[%s]: %d bucket(s) warm %s", self.name,
                        len(self._compiled), list(self.buckets))
        return n_new

    def lower(self, bucket=None):
        raise ConfigError(
            "InferenceEngine.lower() feeds XLA's cost model, a JAX stage "
            "the port has not taken (ROADMAP A13, perf/)")

    # ------------------------------------------------------------ execute

    def infer(self, feed):
        """Serve one request batch: validate, pad to the nearest bucket
        (chunking at the ladder top above it), execute, slice the real
        rows back.  Returns the output tree with host numpy leaves."""
        b = self.validate(feed, batch=True)
        top = self.buckets[-1]
        if b > top:
            chunks = []
            for lo in range(0, b, top):
                n = min(top, b - lo)
                chunks.append(self._infer_bucketed(
                    tree_map(lambda l: _np_leaf(l)[lo:lo + n], feed), n))
            return _concat_rows(chunks)
        return self._infer_bucketed(feed, b)

    def _infer_bucketed(self, feed, b):
        bucket = self.bucket_for(b)
        self._first_run(bucket)
        faults.hit("serving.engine.execute")
        t0 = time.perf_counter()
        with timer("serving_batch"):
            out = self._run(_pad_rows(feed, bucket))
        self.metrics.observe_batch(b, bucket, time.perf_counter() - t0)
        return tree_map(lambda l: l[:b], out)
