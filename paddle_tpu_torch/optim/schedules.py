"""Learning-rate schedules (``paddle_tpu/optim/schedules.py``; reference
parameter/LearningRateScheduler.cpp): constant, poly, exp, discexp,
linear, manual, pass_manual and warmup_cosine.  Each returns
``sched(step) -> lr`` for the optimizer's host step counter, evaluated
in float32 as JAX evaluates it (``jnp.asarray(step, jnp.float32)``), so
a power or a cosine rounds as JAX's does and not in Python's float64.
"""

import numpy as np

_F32 = np.float32


def constant(learning_rate):
    def sched(step):
        return _F32(learning_rate)
    return sched


def poly(learning_rate, decay_a, decay_b):
    """lr * (1 + a t)^(-b) (reference 'poly')."""
    def sched(step):
        base = _F32(1.0) + _F32(decay_a) * _F32(step)
        return _F32(learning_rate) * base ** _F32(-decay_b)
    return sched


def exp(learning_rate, decay_a, decay_b):
    """lr * a^(t / b) (reference 'exp')."""
    def sched(step):
        return _F32(learning_rate) * _F32(decay_a) ** (_F32(step)
                                                       / _F32(decay_b))
    return sched


def discexp(learning_rate, decay_a, decay_b):
    """lr * a^floor(t / b) (reference 'discexp')."""
    def sched(step):
        return _F32(learning_rate) * _F32(decay_a) ** np.floor(
            _F32(step) / _F32(decay_b))
    return sched


def linear(learning_rate, decay_a, decay_b):
    """max(lr - a t, b) (reference 'linear')."""
    def sched(step):
        return np.maximum(_F32(learning_rate) - _F32(decay_a) * _F32(step),
                          _F32(decay_b))
    return sched


def manual(learning_rate, segments):
    """Piecewise constant by the step counter (reference 'manual',
    ManualLRS): segments = [(boundary, multiplier), ...], lr times the
    multiplier of the first segment whose boundary >= the step (a step
    equal to a boundary keeps that segment: searchsorted side="left"),
    the last multiplier past them all."""
    bounds = np.asarray([b for b, _ in segments], _F32)
    mults = np.asarray([m for _, m in segments] + [segments[-1][1]], _F32)

    def sched(step):
        idx = np.searchsorted(bounds, _F32(step), side="left")
        return _F32(learning_rate) * mults[idx]
    return sched


def pass_manual(learning_rate, segments, steps_per_pass):
    """Piecewise constant by PASS (reference 'pass_manual',
    PassManualLRS): segments = [(pass_boundary, multiplier), ...], the
    pass being step // steps_per_pass."""
    if not steps_per_pass or steps_per_pass < 1:
        raise ValueError("pass_manual needs steps_per_pass >= 1 (batches "
                         "per pass) to derive the pass index under jit")
    base = manual(learning_rate, segments)

    def sched(step):
        return base(int(step) // steps_per_pass)
    return sched


def warmup_cosine(learning_rate, warmup_steps, total_steps, min_ratio=0.0):
    """Linear warm-up over ``warmup_steps``, then a cosine from lr down to
    ``min_ratio`` lr at ``total_steps`` (JAX's addition for the
    transformer family)."""
    def sched(step):
        t = _F32(step)
        if t < warmup_steps:
            return _F32(learning_rate) * (t / _F32(max(warmup_steps, 1)))
        progress = np.clip((t - _F32(warmup_steps))
                           / _F32(max(total_steps - warmup_steps, 1)),
                           _F32(0), _F32(1))
        cos = _F32(min_ratio) + _F32(1 - min_ratio) * _F32(0.5) * (
            _F32(1) + np.cos(_F32(np.pi) * progress))
        return _F32(learning_rate) * cos
    return sched


def get(name, learning_rate, decay_a=0.0, decay_b=0.0, segments=None, **kw):
    """Reference config: the learning_rate_schedule string of
    OptimizationConfig, with its decay_a / decay_b / segments and (for
    pass_manual, warmup_cosine) the keywords of the schedule."""
    if name in (None, "constant"):
        return constant(learning_rate)
    if name == "poly":
        return poly(learning_rate, decay_a, decay_b)
    if name == "exp":
        return exp(learning_rate, decay_a, decay_b)
    if name == "discexp":
        return discexp(learning_rate, decay_a, decay_b)
    if name == "linear":
        return linear(learning_rate, decay_a, decay_b)
    if name == "manual":
        return manual(learning_rate, segments)
    if name == "pass_manual":
        return pass_manual(learning_rate, segments, kw.get("steps_per_pass"))
    if name == "warmup_cosine":
        return warmup_cosine(learning_rate, **kw)
    raise KeyError(f"unknown lr schedule {name!r}")
