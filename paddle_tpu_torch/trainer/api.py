"""v2-style top-level API (``paddle_tpu/trainer/api.py``: paddle.init /
paddle.infer equivalents)."""


def init(**kwargs):
    """Reference: paddle.v2.init(use_gpu=, trainer_count=).  Sets each
    known key of the process flags (``utils/flags.FLAGS``), ignores the
    unknown ones and returns ``FLAGS``, as JAX's."""
    from paddle_tpu_torch.utils.flags import FLAGS
    for k, v in kwargs.items():
        if hasattr(FLAGS, k):
            setattr(FLAGS, k, v)
    return FLAGS


def infer(output_layer=None, parameters=None, input=None, feeding=None,
          device=None):
    """Reference: paddle.v2.infer(output_layer=, parameters=, input=),
    on the card unless device="cpu"."""
    from paddle_tpu_torch.trainer.trainer import infer as _infer
    return _infer(output_layer, parameters, input, feeding=feeding,
                  device=device)
