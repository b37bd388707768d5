"""paddle.v2.inference (``paddle_tpu/v2/inference.py``; reference
v2/inference.py:11-73): ``Inference`` wraps the trainer's
``Inferencer``, the topology in test mode on the card unless "cpu".

The reference's Inference ran the GradientMachine in test mode.  JAX's
routes each call through a bucketed ahead-of-time engine, one a row
signature in a bounded LRU keyed by the feed's tree structure, so that
ragged batch sizes never retrace; an eager forward compiles nothing, so
here each call runs the forward directly and there is no engine cache
(nor its ``buckets`` / ``max_engines`` arguments or eviction metrics).
"""

from paddle_tpu_torch.trainer.trainer import Inferencer


class Inference:
    """v2-style inference object.  output_layer: a LayerOutput (or a
    list); parameters: v2 Parameters or a raw tree."""

    def __init__(self, output_layer, parameters, model_state=None,
                 device=None):
        from paddle_tpu_torch.v2.parameters import Parameters
        tree = parameters.tree if isinstance(parameters, Parameters) \
            else parameters
        self._inferencer = Inferencer(output_layer, tree,
                                      model_state=model_state,
                                      device=device)

    def infer(self, input, feeding=None):
        """The outputs on one batch: a feed dict, or host samples with
        ``feeding`` ({data_layer_name: InputType} or a DataFeeder)."""
        return self._inferencer.infer(input, feeding=feeding)


def infer(output_layer, parameters, input, feeding=None, device=None):
    return Inference(output_layer, parameters, device=device).infer(
        input, feeding=feeding)
