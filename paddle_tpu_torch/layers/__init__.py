"""Layer DSL (the reference's trainer_config_helpers surface) and its
graph IR (``paddle_tpu/layers``), under the JAX names: a config written
``import paddle_tpu_torch.layers as L`` reads as the JAX one does.

Ported: the graph (``Topology``, ``LayerOutput``, ``Context``,
``params_from_numpy``), every ctor of ``api.py`` (data, fc, embedding,
the elementwise and sequence layers, ``mixed_layer`` with its
projections and operators, the cost zoo, the CRF and CTC layers,
``nce_layer``, ``hsigmoid`` and ``moe_layer``), the arithmetic on
``LayerOutput`` (``layer_math``: ``+ - *`` and ``L.layer_math.exp``
...; importing this package installs the operators), the recurrent
layers (``recurrent.py``: the whole-sequence ``lstmemory``,
``grumemory`` and ``recurrent_layer``, and ``recurrent_group`` with
``memory``, ``StaticInput``, ``get_output_layer`` and the step layers),
the step units of ``recurrent_units.py``, the conv stack (``vision.py``:
conv, pool, batch norm, LRN, the image utility layers and the conv
parts of ``mixed_layer``) and the composites of ``networks.py`` built on
them (``L.networks.img_conv_group``, ``L.simple_lstm``,
``L.lstmemory_group``, ...).  The generation module (``beam_search``
over a group), nested groups over ``SubsequenceInput`` and
``mdlstmemory`` wait for ROADMAP A10·b item 1b.
"""

from paddle_tpu_torch.layers import api as _api
# installs the LayerOutput arithmetic operators (reference layer_math.py)
from paddle_tpu_torch.layers import layer_math
from paddle_tpu_torch.layers import networks
from paddle_tpu_torch.layers import recurrent as _recurrent
from paddle_tpu_torch.layers import recurrent_units
from paddle_tpu_torch.layers import vision as _vision
from paddle_tpu_torch.layers.api import *          # noqa: F401,F403
from paddle_tpu_torch.layers.graph import (
    Context, LayerOutput, Topology, params_from_numpy, reset_names)
from paddle_tpu_torch.layers.networks import *     # noqa: F401,F403
from paddle_tpu_torch.layers.recurrent import *    # noqa: F401,F403
from paddle_tpu_torch.layers.recurrent_units import *  # noqa: F401,F403
from paddle_tpu_torch.layers.vision import *       # noqa: F401,F403

__all__ = (["LayerOutput", "Topology", "Context", "params_from_numpy",
            "reset_names", "networks", "layer_math", "recurrent_units"]
           + _api.__all__ + _recurrent.__all__ + _vision.__all__
           + networks.__all__ + recurrent_units.__all__)
