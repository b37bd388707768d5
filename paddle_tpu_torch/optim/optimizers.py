"""First-order optimizers (``paddle_tpu/optim/optimizers.py``; reference
FirstOrderOptimizer + OptimizerWithRegularizer / WithGradientClipping).

API as in the JAX package: ``factory(**cfg) -> Optimizer(init, update)``
with ``init(params) -> {"step", "slots"}`` and ``update(grads, state,
params) -> (params, state)`` over nested dicts of tensors.  The JAX step
donates params and optimizer state (``bench.py:335``), so here the update
writes both in place, under ``torch.no_grad()``, and returns the same
trees.  Only Momentum is ported; the other optimizers and the sparse
``row_init`` / ``row_update`` path (with its caller-supplied
``clip_scale``) are not yet (ROADMAP).
"""

from typing import Any, Callable, NamedTuple

import torch

from paddle_tpu_torch.optim import schedules
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _resolve_sched(learning_rate, learning_rate_schedule):
    if callable(learning_rate):
        return learning_rate
    return schedules.get(learning_rate_schedule, learning_rate)


def _apply_decay(params, grads, l2=0.0, l1=0.0):
    """Fold decay into the gradient: g <- g + l2 w (+ l1 sign(w))."""
    if l2 == 0.0 and l1 == 0.0:
        return grads

    def fold(g, p):
        out = g
        if l2:
            out = out + l2 * p
        if l1:
            out = out + l1 * torch.sign(p)
        return out
    return tree_map(fold, grads, params)


def _clip(grads, clip_threshold=None, clip_norm=None):
    """Per-element value clip at clip_threshold, then global-norm
    clipping at clip_norm."""
    if clip_threshold:
        grads = tree_map(lambda g: torch.clamp(g, -clip_threshold,
                                               clip_threshold), grads)
    if clip_norm:
        gn = torch.sqrt(sum(torch.sum(torch.square(g))
                            for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp(clip_norm / gn, max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    return grads


def _make(update_one, extra_state_fn, learning_rate, learning_rate_schedule,
          l1=0.0, l2=0.0, clip_threshold=None, clip_norm=None):
    sched = _resolve_sched(learning_rate, learning_rate_schedule)

    def init(params):
        return {"step": 0, "slots": extra_state_fn(params)}

    def update(grads, state, params):
        step = state["step"]
        lr = float(sched(step))
        with torch.no_grad():
            grads = _clip(grads, clip_threshold, clip_norm)
            grads = _apply_decay(params, grads, l2=l2, l1=l1)
            update_one(grads, state["slots"], params, lr, step)
        state["step"] = step + 1
        return params, state

    return Optimizer(init=init, update=update)


def Momentum(learning_rate=0.01, momentum=0.9, nesterov=False,
             learning_rate_schedule=None, **kw):
    """SGD with momentum (reference sgdUpdate,
    ParameterUpdateFunctions.cpp:33: mom = m*mom - lr*g; w += mom)."""
    def slots(params):
        return {"mom": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        for p, m, g in zip(tree_leaves(params), tree_leaves(s["mom"]),
                           tree_leaves(grads)):
            m.mul_(momentum).add_(g, alpha=-lr)
            if nesterov:
                p.add_(m, alpha=momentum).add_(g, alpha=-lr)
            else:
                p.add_(m)

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)
