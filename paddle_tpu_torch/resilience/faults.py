"""Deterministic fault injection: named fault points in the hot paths
(``paddle_tpu/resilience/faults.py``, copied JAX-free).

A small registry of NAMED fault points sits in the host-side hot paths
as near-zero-cost hooks:

    from paddle_tpu_torch.resilience import faults
    ...
    faults.hit("serving.decode_step")     # one global check when idle

With no plan installed (the default) ``hit()`` is a function call plus
one ``is None`` test: it cannot allocate, touch a lock or the card.  The
hooks live strictly in HOST code, between device calls, so an installed
plan changes no kernel launch either.

A ``FaultPlan`` is a set of per-point rules, each fully deterministic:

* ``at=N``      fire on the Nth hit of that point (1-based), once
* ``every=K``   fire on every Kth hit
* ``p=0.25``    fire with probability p from a ``random.Random(seed)``
                stream private to the point — the same seed replays the
                same fire pattern bit for bit, in this package and in
                the JAX package alike
* ``times=T``   cap total fires of the rule (default: 1 for ``at``,
                unbounded otherwise)
* ``action=error`` (default) raises ``InjectedFault`` (a
  ``TransientError``); ``action=hang`` sleeps ``hang_s`` seconds then
  RETURNS — the hook's caller proceeds normally, simulating a hung or
  slow step.

Spec strings (the ``resilience_fault_spec`` flag and the server's
``--fault-spec``):

    point:key=val,key=val[;point:key=val...]
    e.g.  serving.decode_step:at=4
          trainer.step:every=3,times=2
          batcher.submit:p=0.5,seed=7,action=error

Install with ``install_spec(spec)`` / ``install(plan)``; ``clear()``
removes it.  ``fired_counts()`` exposes per-point fire totals — the
serving ``/metrics`` page renders them as
``fault_injections_total{point=...}``.  The registry is JAX's whole;
the points whose modules are not ported yet (the inference engine, the
router, the fleet, the autoscaler) are registered and never hit.
"""

import random
import threading
import time

from paddle_tpu_torch.utils.error import ConfigError

# The registered fault points.  Each name is compiled into exactly one
# host-side hot path; installing a rule for an unknown name is a
# ConfigError (a typo'd chaos plan must fail loudly, not silently never
# fire).
FAULT_POINTS = (
    "serving.engine.execute",      # InferenceEngine._infer_bucketed
    "serving.prefill",             # DecodeEngine.prefill
    "serving.decode_step",         # DecodeEngine.step (host wrapper)
    "batcher.submit",              # Batcher.submit / GenerationBatcher.submit
    "data.prefetch.h2d",           # ShardedPrefetcher producer placement
    "trainer.step",                # SGD.train hot loop, before dispatch
    "trainer.checkpoint.write",    # checkpoint.save_checkpoint mid-write
    "router.dispatch",             # Router._dispatch, the router->replica
    #                                network boundary (serving/router.py)
    "fleet.spawn",                 # ReplicaSupervisor._spawn, before the
    #                                subprocess exists (serving/fleet.py):
    #                                a replica that fails/hangs AT spawn,
    #                                before it could ever answer /readyz
    "autoscaler.scale",            # Autoscaler actuation (serving/
    #                                autoscaler.py): a scale decision
    #                                whose execution fails — the control
    #                                loop must retry with backoff, never
    #                                count an unready replica as capacity
)


class TransientError(RuntimeError):
    """Base for failures a bounded retry may legitimately absorb."""


class InjectedFault(TransientError):
    """Raised by a firing fault point.  Carries the point name and the
    1-based hit index it fired on, so a chaos test can assert exactly
    which occurrence tripped."""

    def __init__(self, point, hit_index):
        super().__init__(f"injected fault at {point} (hit #{hit_index})")
        self.point = point
        self.hit_index = hit_index


class _Rule:
    __slots__ = ("point", "at", "every", "p", "seed", "times", "action",
                 "hang_s", "hits", "fired", "_rng")

    def __init__(self, point, at=None, every=None, p=None, seed=0,
                 times=None, action="error", hang_s=0.5):
        if point not in FAULT_POINTS:
            raise ConfigError(
                f"unknown fault point {point!r}; registered points: "
                f"{', '.join(FAULT_POINTS)}")
        if sum(x is not None for x in (at, every, p)) != 1:
            raise ConfigError(
                f"fault rule for {point}: exactly one of at=/every=/p= "
                "must be given")
        if action not in ("error", "hang"):
            raise ConfigError(f"fault rule for {point}: action={action!r} "
                              "(supported: error, hang)")
        self.point = point
        self.at = int(at) if at is not None else None
        self.every = int(every) if every is not None else None
        self.p = float(p) if p is not None else None
        self.seed = int(seed)
        # at= is a one-shot by default; every=/p= fire unbounded
        self.times = (int(times) if times is not None
                      else (1 if at is not None else None))
        self.action = action
        self.hang_s = float(hang_s)
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(self.seed)

    def should_fire(self):
        """Advance the rule's deterministic schedule by one hit."""
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None:
            return self.hits == self.at
        if self.every is not None:
            return self.hits % self.every == 0
        return self._rng.random() < self.p


class FaultPlan:
    """A seeded, replayable set of fault rules, one per point at most."""

    def __init__(self, rules=()):
        self._rules = {}
        self._lock = threading.Lock()
        for r in rules:
            if r.point in self._rules:
                raise ConfigError(f"duplicate fault rule for {r.point}")
            self._rules[r.point] = r

    @classmethod
    def from_spec(cls, spec):
        """Parse ``point:k=v,k=v[;point:...]`` into a plan."""
        rules = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if ":" not in part:
                raise ConfigError(
                    f"fault spec entry {part!r}: expected point:key=val,...")
            point, _, kvs = part.partition(":")
            kw = {}
            for kv in filter(None, (s.strip() for s in kvs.split(","))):
                if "=" not in kv:
                    raise ConfigError(
                        f"fault spec for {point}: bad key=val {kv!r}")
                k, _, v = kv.partition("=")
                k = k.strip()
                if k in ("at", "every", "seed", "times"):
                    kw[k] = int(v)
                elif k in ("p", "hang_s"):
                    kw[k] = float(v)
                elif k == "action":
                    kw[k] = v.strip()
                else:
                    raise ConfigError(
                        f"fault spec for {point}: unknown key {k!r}")
            rules.append(_Rule(point.strip(), **kw))
        return cls(rules)

    def hit(self, point):
        rule = self._rules.get(point)
        if rule is None:
            return
        with self._lock:
            fire = rule.should_fire()
            if fire:
                rule.fired += 1
                idx = rule.hits
                action, hang_s = rule.action, rule.hang_s
        if not fire:
            return
        if action == "hang":
            time.sleep(hang_s)
            return
        raise InjectedFault(point, idx)

    def snapshot(self):
        """{point: {"hits": n, "fired": n}} for every rule in the plan."""
        with self._lock:
            return {p: {"hits": r.hits, "fired": r.fired}
                    for p, r in self._rules.items()}


# the globally installed plan; None (the default) makes hit() a no-op
_plan = None


def install(plan):
    """Install a FaultPlan process-wide; returns it (chainable)."""
    global _plan
    _plan = plan
    return plan


def install_spec(spec):
    """Parse + install a spec string; empty/None clears instead."""
    if not spec:
        clear()
        return None
    return install(FaultPlan.from_spec(spec))


def clear():
    global _plan
    _plan = None


def active_plan():
    return _plan


def hit(point):
    """The hook compiled into the hot paths.  Near-zero cost when no
    plan is installed (one global read + ``is None``).  The local
    snapshot makes a concurrent clear() benign — the racing hit sees
    either the old plan or none, never a half-torn-down one."""
    plan = _plan
    if plan is None:
        return
    plan.hit(point)


def fired_counts():
    """{point: fires} of the active plan ({} when none) — the /metrics
    ``fault_injections_total`` source."""
    plan = _plan
    if plan is None:
        return {}
    return {p: s["fired"] for p, s in plan.snapshot().items()}
