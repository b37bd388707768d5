"""Resilience layer (``paddle_tpu/resilience``): deterministic fault
injection (``faults.py``: named fault points in the serving engines and
batchers, the prefetcher, the trainer's step and its checkpoint writer)
and supervised recovery (``supervisor.py``: the step watchdog, slot
re-seating onto a rebuilt cache, the circuit breaker and bounded retry
of transient submits).  The chaos CLI (JAX's ``resilience/__main__.py``)
is ROADMAP A8."""

from paddle_tpu_torch.resilience.faults import (FAULT_POINTS, FaultPlan,
                                                InjectedFault,
                                                TransientError)
from paddle_tpu_torch.resilience.supervisor import (BreakerOpenError,
                                                    CircuitBreaker,
                                                    Supervisor,
                                                    WatchdogTimeout,
                                                    retry_transient)

__all__ = [
    "FAULT_POINTS", "FaultPlan", "InjectedFault", "TransientError",
    "BreakerOpenError", "CircuitBreaker", "Supervisor",
    "WatchdogTimeout", "retry_transient",
]
