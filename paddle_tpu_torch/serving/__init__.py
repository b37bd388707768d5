"""Serving on the port (``paddle_tpu/serving``): the bucketed inference
engine and its dynamic batcher (the ``/v1/infer`` plane), the slot-based
decode engine with its continuous-batching request front (the generation
plane), the paged KV pool and its host tier, the cross-replica KV
handoff, the HTTP server, and the multi-process tier over it: the
replica fleet supervisor (``fleet``), the health-checked router with
mid-stream failover and prefill/decode handoff (``router``), its
overload control (``overload``) and the autoscaler (``autoscaler``).

    python -m paddle_tpu_torch.serving [--demo-generate] --port 8080
    python -m paddle_tpu_torch.serving.router --replicas 2 --port 8000
    python -m paddle_tpu_torch.serving.autoscaler --min-replicas 1
"""

from paddle_tpu_torch.resilience.supervisor import BreakerOpenError, Supervisor
from paddle_tpu_torch.serving.autoscaler import Autoscaler
from paddle_tpu_torch.serving.batcher import Batcher
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    GenerationBatcher)
from paddle_tpu_torch.serving.engine import DEFAULT_BUCKETS, InferenceEngine
from paddle_tpu_torch.serving.errors import (BatchExecutionError,
                                             DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.overload import (AIMDLimiter, BrownoutLadder,
                                               OverloadController, ShedError)
from paddle_tpu_torch.serving.router import Router, RouterMetrics
from paddle_tpu_torch.serving.server import make_server

__all__ = [
    "AIMDLimiter", "Autoscaler", "Batcher", "BatchExecutionError",
    "BreakerOpenError", "BrownoutLadder", "DeadlineExceededError",
    "DecodeEngine", "DEFAULT_BUCKETS", "GenerationBatcher",
    "InferenceEngine", "InvalidRequestError", "OverloadedError",
    "OverloadController", "ReplicaSupervisor", "Router", "RouterMetrics",
    "ServingMetrics", "ShedError", "ShutdownError", "Supervisor",
    "make_server",
]
