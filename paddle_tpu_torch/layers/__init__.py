"""Layer DSL (the reference's trainer_config_helpers surface) and its
graph IR (``paddle_tpu/layers``), under the JAX names: a config written
``import paddle_tpu_torch.layers as L`` reads as the JAX one does.

Ported: the graph (``Topology``, ``LayerOutput``, ``Context``,
``params_from_numpy``), the data / fc / embedding / concat / pooling
layers, the classification cost and ``moe_layer`` (``api.py``), and the
whole-sequence recurrent layers (``recurrent.py``).  The vision, networks and
generation modules, ``recurrent_group`` and the layer arithmetic wait
for ROADMAP A10·b.
"""

from paddle_tpu_torch.layers import api as _api
from paddle_tpu_torch.layers import recurrent as _recurrent
from paddle_tpu_torch.layers.api import *          # noqa: F401,F403
from paddle_tpu_torch.layers.graph import (
    Context, LayerOutput, Topology, params_from_numpy, reset_names)
from paddle_tpu_torch.layers.recurrent import *    # noqa: F401,F403

__all__ = (["LayerOutput", "Topology", "Context", "params_from_numpy",
            "reset_names"] + _api.__all__ + _recurrent.__all__)
