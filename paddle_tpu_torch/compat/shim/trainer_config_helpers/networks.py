"""A re-export of the trainer_config_helpers names (see the package)."""

from paddle_tpu_torch.compat.shim.trainer_config_helpers import *  # noqa
