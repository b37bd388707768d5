"""``python -m paddle_tpu_torch train|test --config cfg.py``: the
trainer CLI (``trainer/cli.py``)."""

import sys

from paddle_tpu_torch.trainer.cli import main

sys.exit(main())
