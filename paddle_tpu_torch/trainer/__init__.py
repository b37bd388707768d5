"""Training driver (``paddle_tpu/trainer``): ``SGD``, its event stream,
checkpoints in the JAX trainer's format, and the ``train`` / ``test``
CLI.  ``Trainer``, ``Inferencer``, the pruning hooks and
``merge_model`` wait for ROADMAP A9·c."""

from paddle_tpu_torch.trainer import events
from paddle_tpu_torch.trainer.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from paddle_tpu_torch.trainer.trainer import SGD

__all__ = ["SGD", "events", "save_checkpoint", "load_checkpoint"]
