"""Generation serving on the port: the slot-based decode engine, its
continuous-batching request front and the HTTP server
(``paddle_tpu/serving``'s generation plane)."""

from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    GenerationBatcher)
from paddle_tpu_torch.serving.errors import (BatchExecutionError,
                                             DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.server import make_server

__all__ = ["DecodeEngine", "GenerationBatcher", "ServingMetrics",
           "make_server", "BatchExecutionError", "DeadlineExceededError",
           "InvalidRequestError", "OverloadedError", "ShutdownError"]
