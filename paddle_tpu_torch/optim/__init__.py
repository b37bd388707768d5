"""Optimizers, learning-rate schedules and Polyak averaging
(``paddle_tpu/optim``), with JAX's exports: ``optim.schedules`` and
``optim.averaging`` are modules of the namespace."""

from paddle_tpu_torch.optim import averaging, schedules
from paddle_tpu_torch.optim.optimizers import (
    AdaDelta, AdaGrad, AdaMax, Adam, DecayedAdaGrad, Momentum, Optimizer,
    RMSProp, get)

__all__ = ["Optimizer", "Momentum", "AdaGrad", "AdaDelta", "RMSProp",
           "DecayedAdaGrad", "Adam", "AdaMax", "get", "schedules",
           "averaging"]
