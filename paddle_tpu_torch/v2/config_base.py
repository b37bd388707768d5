"""paddle.v2.config_base (``paddle_tpu/v2/config_base.py``; reference
v2/config_base.py:1).

The reference's Layer base class adapted v1 config functions into v2
graph objects; the port's layer ctors already return graph nodes
(``LayerOutput``), so that class is the base surface here.
"""

from paddle_tpu_torch.layers.graph import LayerOutput as Layer  # noqa: F401
