"""Optimizers and learning-rate schedules (``paddle_tpu/optim``)."""

from paddle_tpu_torch.optim.optimizers import (
    AdaDelta, AdaGrad, AdaMax, Adam, DecayedAdaGrad, Momentum, Optimizer,
    RMSProp, get)

__all__ = ["AdaDelta", "AdaGrad", "AdaMax", "Adam", "DecayedAdaGrad",
           "Momentum", "Optimizer", "RMSProp", "get"]
