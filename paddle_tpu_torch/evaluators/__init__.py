"""Evaluator suite (``paddle_tpu/evaluators``).

Reference: gserver/evaluators/Evaluator.{h,cpp}:172-1346 REGISTER_EVALUATOR
zoo — classification_error, sum, column_sum, rankauc, precision_recall,
pnpair, auc, chunk (NER F1), ctc_error, printers.

Each evaluator is (init, update, result); the additive statistics stay
tensors on the trainer's device between batches (``evaluators.py``), and
the DSL ctors (``dsl.py``) bind one to graph layers for ``SGD``.
"""

from paddle_tpu_torch.evaluators.evaluators import (
    Evaluator, ClassificationError, Auc, PrecisionRecall, PnPair, RankAuc,
    SumEvaluator, ColumnSum, ChunkEvaluator, CTCError, get,
)
from paddle_tpu_torch.evaluators.dsl import *          # noqa: F401,F403
from paddle_tpu_torch.evaluators import dsl as _dsl

__all__ = [
    "Evaluator", "ClassificationError", "Auc", "PrecisionRecall", "PnPair",
    "RankAuc", "SumEvaluator", "ColumnSum", "ChunkEvaluator", "CTCError",
    "get",
] + _dsl.__all__
