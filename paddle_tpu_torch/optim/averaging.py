"""Polyak parameter averaging with apply/restore
(``paddle_tpu/optim/averaging.py``; reference parameter/
AverageOptimizer.{h,cpp}, the Trainer/Tester's apply and restore).

``AveragerState`` rides beside the optimizer state: a running sum of
the parameters (or an exponential average with ``decay=``) and its
count.  ``apply`` returns the averaged parameters as a new tree and
leaves the live ones alone, so "apply / restore" is evaluating with the
other tree.  Functional, as JAX's: every call returns fresh tensors.
"""

from typing import NamedTuple

import torch

from paddle_tpu_torch.utils.tree import tree_leaves, tree_map


class AveragerState(NamedTuple):
    sum_: object            # tree: the windowed running sum
    count: torch.Tensor     # 0-d float32


def init(params):
    leaf = tree_leaves(params)[0]
    return AveragerState(
        sum_=tree_map(lambda p: torch.zeros_like(p.detach()), params),
        count=torch.zeros((), dtype=torch.float32, device=leaf.device))


def accumulate(state: AveragerState, params, decay=None) -> AveragerState:
    """Once per batch after the optimizer update.  With decay=d the window
    is exponential (the reference's moving-average mode, count 1);
    otherwise a plain running sum."""
    with torch.no_grad():
        if decay is None:
            return AveragerState(
                sum_=tree_map(lambda s, p: s + p, state.sum_, params),
                count=state.count + 1.0)
        return AveragerState(
            sum_=tree_map(lambda s, p: decay * s + (1.0 - decay) * p,
                          state.sum_, params),
            count=torch.ones_like(state.count))


def apply(state: AveragerState, params):
    """The averaged parameters for evaluation; the live ones while
    nothing has been accumulated."""
    def avg(s, p):
        return torch.where(state.count > 0,
                           s / torch.clamp(state.count, min=1.0), p.detach())
    with torch.no_grad():
        return tree_map(avg, state.sum_, params)


def reset(state: AveragerState, params):
    """Start a new window (the reference's startPass roll-over)."""
    return init(params)
