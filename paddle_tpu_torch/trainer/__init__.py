"""Training driver (``paddle_tpu/trainer``): ``SGD`` / ``Trainer``, its
event stream, ``Inferencer`` / ``infer``, checkpoints in the JAX
trainer's format (with its background writer and ``merge_model``), the
pruning hooks and the ``train`` / ``test`` / ``time`` / ``checkgrad`` /
``merge_model`` / ``version`` CLI."""

from paddle_tpu_torch.trainer.trainer import SGD, Trainer, Inferencer, infer
from paddle_tpu_torch.trainer import events
from paddle_tpu_torch.trainer.checkpoint import (
    save_checkpoint, load_checkpoint, merge_model, load_merged)

__all__ = ["SGD", "Trainer", "Inferencer", "infer", "events",
           "save_checkpoint", "load_checkpoint", "merge_model",
           "load_merged"]
