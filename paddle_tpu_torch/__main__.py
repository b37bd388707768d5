"""``python -m paddle_tpu_torch
train|test|time|checkgrad|merge_model|version``: the trainer CLI
(``trainer/cli.py``)."""

import sys

from paddle_tpu_torch.trainer.cli import main

sys.exit(main())
