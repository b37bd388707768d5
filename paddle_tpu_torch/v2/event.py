"""paddle.v2.event (``paddle_tpu/v2/event.py``; reference v2/event.py)."""

from paddle_tpu_torch.trainer.events import (      # noqa: F401
    BeginIteration, BeginPass, EndIteration, EndPass, EndTesting)

# the reference calls the test-result event TestResult
TestResult = EndTesting
