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
``memory``, ``StaticInput``, ``SubsequenceInput`` for nested groups,
``get_output_layer``, the step layers, ``mdlstmemory`` and the
``prev_batch_state`` carry), the step units of ``recurrent_units.py``,
the generation module (``generation.py``: ``GeneratedInput``,
``beam_search`` and ``greedy_generation`` over a step), the conv stack
(``vision.py``: conv, pool, batch norm, LRN, the image utility layers
and the conv parts of ``mixed_layer``), the composites of
``networks.py`` built on them (``L.networks.img_conv_group``,
``L.simple_lstm``, ``L.lstmemory_group``, ...), and JAX's
``LayerType`` constants and ``layer_support`` decorator.
"""

from paddle_tpu_torch.layers import api as _api
from paddle_tpu_torch.layers import generation as _generation
# installs the LayerOutput arithmetic operators (reference layer_math.py)
from paddle_tpu_torch.layers import layer_math
from paddle_tpu_torch.layers import networks
from paddle_tpu_torch.layers import recurrent as _recurrent
from paddle_tpu_torch.layers import recurrent_units
from paddle_tpu_torch.layers import vision as _vision
from paddle_tpu_torch.layers.api import *          # noqa: F401,F403
from paddle_tpu_torch.layers.generation import *   # noqa: F401,F403
from paddle_tpu_torch.layers.graph import (
    Context, LayerOutput, Topology, params_from_numpy, reset_names)
from paddle_tpu_torch.layers.networks import *     # noqa: F401,F403
from paddle_tpu_torch.layers.recurrent import *    # noqa: F401,F403
from paddle_tpu_torch.layers.recurrent_units import *  # noqa: F401,F403
from paddle_tpu_torch.layers.vision import *       # noqa: F401,F403



class LayerType:
    """The reference's LayerType string constants (trainer_config_helpers
    layers.py), for configs that name them; the graph dispatches on
    these type strings."""
    DATA = "data"
    FC_LAYER = "fc"
    MIXED_LAYER = "mixed"
    EMBEDDING_LAYER = "embedding"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "grumemory"
    RECURRENT_LAYER = "recurrent"
    CONV_LAYER = "conv"
    CONVTRANS_LAYER = "conv"
    CUDNNCONV_LAYER = "conv"
    POOL_LAYER = "pool"
    BATCH_NORM_LAYER = "batch_norm"
    CRF_LAYER = "crf"
    CTC_LAYER = "ctc"
    COST = "classification_cost"


def layer_support(*attrs):
    """The reference's layer_support decorator (a ctor's ERROR_CLIPPING /
    DROPOUT support): the layers take those attributes from their cfg,
    so it returns the ctor unchanged."""
    def deco(fn):
        return fn
    return deco


__all__ = (["LayerOutput", "Topology", "Context", "params_from_numpy",
            "reset_names", "networks", "layer_math", "recurrent_units",
            "LayerType", "layer_support"]
           + _api.__all__ + _recurrent.__all__ + _generation.__all__
           + _vision.__all__ + networks.__all__ + recurrent_units.__all__)
