"""v1 config-file compatibility, the reference's config compiler
(``paddle_tpu/compat``).

``compat.v1`` holds the trainer_config_helpers names the reference's
demo and benchmark config scripts import (``from
paddle.trainer_config_helpers import *``); ``compat.config_parser``
executes such a script (reference config_parser.py:3558 parse_config)
and lowers it to the dict the CLI trainer consumes.  While it runs, the
port's own ``compat/shim`` modules stand under the reference's
``paddle.*`` import paths, so reference configs run unchanged without
the repository's root ``paddle/`` package, which imports the JAX one.
"""

from paddle_tpu_torch.compat.config_parser import (  # noqa: F401
    config_to_runtime, parse_config)
