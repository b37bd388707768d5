"""paddle.v2.trainer (``paddle_tpu/v2/trainer.py``; reference
v2/trainer.py:30): SGD with the v2 call shape, SGD(cost, parameters,
update_equation).train(reader, event_handler, num_passes)."""

from paddle_tpu_torch.trainer.trainer import SGD as _SGD


class SGD(_SGD):
    def __init__(self, cost, parameters=None, update_equation=None,
                 extra_layers=None, is_local=True, **kw):
        from paddle_tpu_torch.v2.parameters import Parameters
        tree = parameters.tree if isinstance(parameters, Parameters) \
            else parameters
        super().__init__(cost, parameters=tree,
                         update_equation=update_equation,
                         extra_layers=extra_layers, is_local=is_local, **kw)
        self._v2_parameters = parameters

    def train(self, reader, num_passes=1, event_handler=None, feeding=None,
              **kw):
        super().train(reader, num_passes=num_passes,
                      event_handler=event_handler, feeding=feeding, **kw)
        # keep the caller's Parameters view on the trained tree
        if self._v2_parameters is not None:
            self._v2_parameters.tree = self.parameters
