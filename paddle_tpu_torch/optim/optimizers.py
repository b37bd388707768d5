"""First-order optimizers (``paddle_tpu/optim/optimizers.py``; reference
FirstOrderOptimizer + OptimizerWithRegularizer / WithGradientClipping).

API as in the JAX package: ``factory(**cfg) -> Optimizer(init, update,
row_init, row_update, clip_norm, clip_threshold)`` with ``init(params)
-> {"step", "slots"}`` and ``update(grads, state, params, clip_scale=None)
-> (params, state)`` over nested dicts of tensors.  The JAX step donates
params and optimizer state (``bench.py:335``), so here the update writes
both in place, under ``torch.no_grad()``, and returns the same trees.
All eight of JAX's optimizers are here (Momentum, AdaGrad, AdaDelta,
RMSProp, DecayedAdaGrad, Adam, AdaMax, and ``get`` by name).

The sparse-row interface (reference SparseRowMatrix / sgdUpdateSparse):
``row_init(rows_tree) -> slots`` and ``row_update(grads, slot_rows, rows,
step, clip_scale=None) -> (rows, slot_rows)`` run the same rule on a
gathered block of touched embedding rows (``trainer.SGD``'s sparse
step), at the dense state's ``step``.  ``clip_scale`` takes the place of
the global-norm scale, so a caller that splits the gradient tree across
the two calls applies ONE norm to both (``clip_norm`` and
``clip_threshold`` are exposed for it).  Schedules are
``optim/schedules``', their keywords passed through ``sched_kw``.
"""

from typing import Any, Callable, NamedTuple

import torch

from paddle_tpu_torch.optim import schedules
from paddle_tpu_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]
    row_init: Callable[[Any], Any] = None
    row_update: Callable[..., Any] = None
    clip_norm: float = None
    clip_threshold: float = None


def _resolve_sched(learning_rate, learning_rate_schedule, **kw):
    if callable(learning_rate):
        return learning_rate
    return schedules.get(learning_rate_schedule, learning_rate, **kw)


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


def _clip(grads, clip_threshold=None, clip_norm=None, clip_scale=None):
    """Per-element value clip at clip_threshold, then the global-norm
    scale: ``clip_scale`` where the caller gives one, else the norm's
    min(1, clip_norm / |g|)."""
    if clip_threshold:
        grads = tree_map(lambda g: torch.clamp(g, -clip_threshold,
                                               clip_threshold), grads)
    if clip_scale is not None:
        grads = tree_map(lambda g: g * clip_scale, grads)
    elif clip_norm:
        gn = torch.sqrt(sum(torch.sum(torch.square(g))
                            for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp(clip_norm / gn, max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    return grads


def _make(update_one, extra_state_fn, learning_rate, learning_rate_schedule,
          l1=0.0, l2=0.0, clip_threshold=None, clip_norm=None, sched_kw=None):
    sched = _resolve_sched(learning_rate, learning_rate_schedule,
                           **(sched_kw or {}))

    def init(params):
        return {"step": 0, "slots": extra_state_fn(params)}

    def update(grads, state, params, clip_scale=None):
        step = state["step"]
        lr = float(sched(step))
        with torch.no_grad():
            grads = _clip(grads, clip_threshold, clip_norm, clip_scale)
            grads = _apply_decay(params, grads, l2=l2, l1=l1)
            update_one(grads, state["slots"], params, lr, step)
        state["step"] = step + 1
        return params, state

    def row_update(grads, slot_rows, rows, step, clip_scale=None):
        lr = float(sched(step))
        with torch.no_grad():
            grads = _clip(grads, clip_threshold, clip_norm, clip_scale)
            grads = _apply_decay(rows, grads, l2=l2, l1=l1)
            update_one(grads, slot_rows, rows, lr, step)
        return rows, slot_rows

    return Optimizer(init=init, update=update, row_init=extra_state_fn,
                     row_update=row_update, clip_norm=clip_norm,
                     clip_threshold=clip_threshold)


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


def Adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
         learning_rate_schedule=None, **kw):
    """Reference AdamParameterOptimizer with bias correction, as the JAX
    package writes it: t = step + 1 in float32, m and v scaled by
    1 / (1 - beta^t), epsilon added after the square root.  One
    multi-tensor call per operation over every leaf."""
    def slots(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        t = torch.tensor(step + 1, dtype=torch.float32)
        mhat_scale = float(1.0 / (1.0 - beta1 ** t))
        vhat_scale = float(1.0 / (1.0 - beta2 ** t))
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(s["m"]), tree_leaves(s["v"])
        torch._foreach_mul_(ms, beta1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - beta1))
        torch._foreach_mul_(vs, beta2)
        g2 = torch._foreach_mul(gs, 1 - beta2)
        torch._foreach_mul_(g2, gs)
        torch._foreach_add_(vs, g2)
        den = torch._foreach_mul(vs, vhat_scale)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, epsilon)
        num = torch._foreach_mul(ms, mhat_scale)
        torch._foreach_mul_(num, lr)
        torch._foreach_div_(num, den)
        torch._foreach_sub_(ps, num)

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)


def _leaves(*trees):
    """The leaves of same-shaped trees, zipped."""
    return zip(*(tree_leaves(t) for t in trees))


def AdaGrad(learning_rate=0.01, epsilon=1e-6, learning_rate_schedule=None,
            **kw):
    """Reference AdagradParameterOptimizer: accum += g^2;
    w -= lr * g / (sqrt(accum) + eps)."""
    def slots(params):
        return {"accum": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        for p, g, a in _leaves(params, grads, s["accum"]):
            a.addcmul_(g, g)
            p.sub_(lr * g / (torch.sqrt(a) + epsilon))

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)


def AdaDelta(learning_rate=1.0, rho=0.95, epsilon=1e-6,
             learning_rate_schedule=None, **kw):
    """Reference AdaDeltaParameterOptimizer: E[g2] = rho E[g2] + (1-rho)
    g^2; dx = g sqrt((E[dx2] + eps) / (E[g2] + eps)); E[dx2] = rho E[dx2]
    + (1-rho) dx^2; w -= lr dx."""
    def slots(params):
        return {"eg2": tree_map(torch.zeros_like, params),
                "edx2": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        for p, g, eg2, edx2 in _leaves(params, grads, s["eg2"], s["edx2"]):
            eg2.copy_(rho * eg2 + (1 - rho) * g * g)
            dx = g * torch.sqrt((edx2 + epsilon) / (eg2 + epsilon))
            edx2.copy_(rho * edx2 + (1 - rho) * dx * dx)
            p.sub_(lr * dx)

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)


def RMSProp(learning_rate=0.01, rho=0.95, epsilon=1e-6,
            learning_rate_schedule=None, **kw):
    """Reference RMSPropParameterOptimizer, the centered variant:
    E[g2] = rho E[g2] + (1-rho) g^2; E[g] = rho E[g] + (1-rho) g;
    w -= lr g / sqrt(E[g2] - E[g]^2 + eps)."""
    def slots(params):
        return {"eg2": tree_map(torch.zeros_like, params),
                "eg": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        for p, g, eg2, eg in _leaves(params, grads, s["eg2"], s["eg"]):
            eg2.copy_(rho * eg2 + (1 - rho) * g * g)
            eg.copy_(rho * eg + (1 - rho) * g)
            p.sub_(lr * g / torch.sqrt(eg2 - eg * eg + epsilon))

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)


def DecayedAdaGrad(learning_rate=0.01, rho=0.95, epsilon=1e-6,
                   learning_rate_schedule=None, **kw):
    """Reference DecayedAdagradParameterOptimizer: RMSProp without the
    mean term, accum = rho accum + (1-rho) g^2; w -= lr g / sqrt(accum +
    eps)."""
    def slots(params):
        return {"accum": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        for p, g, a in _leaves(params, grads, s["accum"]):
            a.copy_(rho * a + (1 - rho) * g * g)
            p.sub_(lr * g / torch.sqrt(a + epsilon))

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)


def AdaMax(learning_rate=2e-3, beta1=0.9, beta2=0.999,
           learning_rate_schedule=None, **kw):
    """Reference AdamaxParameterOptimizer: m = beta1 m + (1-beta1) g;
    u = max(beta2 u, |g|); w -= lr / (1 - beta1^t) m / (u + 1e-12), with
    t = step + 1 in float32 as the JAX package computes it."""
    def slots(params):
        return {"m": tree_map(torch.zeros_like, params),
                "u": tree_map(torch.zeros_like, params)}

    def upd(grads, s, params, lr, step):
        t = torch.tensor(step + 1, dtype=torch.float32)
        rate = float(lr / (1 - beta1 ** t))
        for p, g, m, u in _leaves(params, grads, s["m"], s["u"]):
            m.copy_(beta1 * m + (1 - beta1) * g)
            u.copy_(torch.maximum(beta2 * u, torch.abs(g)))
            p.sub_(rate * m / (u + 1e-12))

    return _make(upd, slots, learning_rate, learning_rate_schedule, **kw)


_REGISTRY = {
    "momentum": Momentum, "sgd": Momentum, "adagrad": AdaGrad,
    "adadelta": AdaDelta, "rmsprop": RMSProp,
    "decayed_adagrad": DecayedAdaGrad, "adam": Adam, "adamax": AdaMax,
}


def get(name, **kw):
    """The optimizer named ``name`` (case-insensitive), built with ``kw``."""
    try:
        return _REGISTRY[name.lower()](**kw)
    except KeyError:
        raise KeyError(f"unknown optimizer {name!r}; have "
                       f"{sorted(_REGISTRY)}")
