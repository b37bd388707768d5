"""v2-style top-level API (``paddle_tpu/trainer/api.py``: paddle.init /
paddle.infer equivalents)."""

from paddle_tpu_torch.utils.error import ConfigError


def init(**kwargs):
    """Reference: paddle.v2.init(use_gpu=, trainer_count=).  It sets the
    process flags (``utils/flags``), which are not ported yet."""
    raise ConfigError("trainer.api.init sets utils/flags, which is not "
                      "ported yet (ROADMAP A5)")


def infer(output_layer=None, parameters=None, input=None, feeding=None,
          device=None):
    """Reference: paddle.v2.infer(output_layer=, parameters=, input=),
    on the card unless device="cpu"."""
    from paddle_tpu_torch.trainer.trainer import infer as _infer
    return _infer(output_layer, parameters, input, feeding=feeding,
                  device=device)
