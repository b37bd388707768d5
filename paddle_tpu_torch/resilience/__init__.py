"""Resilience layer (``paddle_tpu/resilience``): deterministic fault
injection (``faults.py``), named fault points in the serving engine and
batcher, the prefetcher, the trainer's step and its checkpoint writer.
Supervised recovery (``supervisor.py``: watchdog, circuit breaker,
bounded retry) is ROADMAP A8; until then a fault ends the requests it
reaches as JAX's unsupervised batcher ends them."""

from paddle_tpu_torch.resilience.faults import (FAULT_POINTS, FaultPlan,
                                                InjectedFault,
                                                TransientError)

__all__ = ["FAULT_POINTS", "FaultPlan", "InjectedFault", "TransientError"]
