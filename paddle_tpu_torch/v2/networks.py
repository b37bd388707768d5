"""paddle.v2.networks (``paddle_tpu/v2/networks.py``; reference
v2/networks.py re-exporting trainer_config_helpers.networks)."""

from paddle_tpu_torch.layers.networks import *          # noqa: F401,F403
from paddle_tpu_torch.layers.networks import __all__    # noqa: F401
