"""Optimizers and learning-rate schedules (``paddle_tpu/optim``)."""

from paddle_tpu_torch.optim.optimizers import Adam, Momentum, Optimizer

__all__ = ["Adam", "Momentum", "Optimizer"]
