"""Optimizers and learning-rate schedules (``paddle_tpu/optim``)."""

from paddle_tpu_torch.optim.optimizers import Momentum, Optimizer

__all__ = ["Momentum", "Optimizer"]
