"""``python -m paddle_tpu_torch.serving`` — the generation server CLI
(server.py)."""

import sys

from paddle_tpu_torch.serving.server import main

sys.exit(main())
