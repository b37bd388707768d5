"""Learning-rate schedules (``paddle_tpu/optim/schedules.py``; reference
LearningRateScheduler.cpp).  Each returns ``sched(step) -> lr``.  Only
the constant schedule is ported; the others raise (ROADMAP)."""

_NOT_PORTED = ("poly", "exp", "discexp", "linear", "manual", "pass_manual",
               "warmup_cosine")


def constant(learning_rate):
    def sched(step):
        return float(learning_rate)
    return sched


def get(name, learning_rate):
    """Reference config: learning_rate_schedule string in
    OptimizationConfig."""
    if name in (None, "constant"):
        return constant(learning_rate)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"lr schedule {name!r} is not yet ported "
                                  "to paddle_tpu_torch (ROADMAP)")
    raise KeyError(f"unknown lr schedule {name!r}")
