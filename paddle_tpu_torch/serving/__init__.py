"""Serving on the port (``paddle_tpu/serving``, one server process's
surface): the bucketed inference engine and its dynamic batcher (the
``/v1/infer`` plane), the slot-based decode engine with its
continuous-batching request front (the generation plane), the paged KV
pool and its host tier, the cross-replica KV handoff, and the HTTP
server.  The multi-process parts (``fleet``, ``router``, ``overload``,
``autoscaler``) are ROADMAP A8."""

from paddle_tpu_torch.resilience.supervisor import BreakerOpenError, Supervisor
from paddle_tpu_torch.serving.batcher import Batcher
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    GenerationBatcher)
from paddle_tpu_torch.serving.engine import DEFAULT_BUCKETS, InferenceEngine
from paddle_tpu_torch.serving.errors import (BatchExecutionError,
                                             DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.server import make_server

__all__ = ["Batcher", "BatchExecutionError", "BreakerOpenError",
           "DeadlineExceededError", "DecodeEngine", "DEFAULT_BUCKETS",
           "GenerationBatcher", "InferenceEngine", "InvalidRequestError",
           "OverloadedError", "ServingMetrics", "ShutdownError",
           "Supervisor", "make_server"]
