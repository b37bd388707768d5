"""Testing utilities (``paddle_tpu/testing``; reference paddle/testing/
and the --job=checkgrad trainer mode).  The gradient check is ported;
the retrace guards (``testing/trace.py``) have no counterpart in an
eager port and the kernel smoke / TPU diff harnesses wait for ROADMAP
A13."""

from paddle_tpu_torch.testing.gradcheck import (check_grads,
                                                check_topology_grads)

__all__ = ["check_topology_grads", "check_grads"]
