"""paddle.v2.evaluator (``paddle_tpu/v2/evaluator.py``; reference
v2/evaluator.py re-exporting the evaluator ctors)."""

from paddle_tpu_torch.evaluators.dsl import *     # noqa: F401,F403
from paddle_tpu_torch.evaluators.dsl import __all__  # noqa: F401
