"""paddle.v2.topology (``paddle_tpu/v2/topology.py``; reference
v2/topology.py:1).

The reference's Topology wrapped the serialized ModelConfig proto and
answered get_layer / data_type queries; here the graph's ``Topology`` is
that object, re-exported under the reference's name (layers by name
through ``.order``, the data layers in ``.data_layers``).
"""

from paddle_tpu_torch.layers.graph import Topology  # noqa: F401
