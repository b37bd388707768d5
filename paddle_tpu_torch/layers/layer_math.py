"""Arithmetic on ``LayerOutput`` (``paddle_tpu/layers/layer_math.py``;
reference trainer_config_helpers/layer_math.py): the unary math ops as
identity-projection mixed layers with the matching activation, and
``+``, ``-``, ``*`` with a number or another layer, a size-1 operand
broadcast through ``repeat_layer`` / ``scaling_layer``.  Importing
``paddle_tpu_torch.layers`` installs the operators."""

from paddle_tpu_torch.layers import api as _api
from paddle_tpu_torch.layers.graph import LayerOutput
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["exp", "log", "abs", "sigmoid", "tanh", "square", "relu",
           "sqrt"]


def _unary(act_name):
    def op(input, name=None):
        return _api.mixed_layer(size=input.size,
                                input=[_api.identity_projection(input)],
                                act=act_name, name=name)
    return op


exp = _unary("exponential")
log = _unary("log")
abs = _unary("abs")            # noqa: A001 - the reference's name
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
square = _unary("square")
relu = _unary("relu")
sqrt = _unary("sqrt")


def _add(a, b):
    if isinstance(b, (int, float)):
        return _api.slope_intercept_layer(input=a, slope=1.0, intercept=b)
    if not isinstance(b, LayerOutput):
        raise ConfigError("LayerOutput + needs a LayerOutput or a number")
    if a.size != b.size:
        if a.size != 1 and b.size != 1:
            raise ConfigError(f"cannot add sizes {a.size} and {b.size}")
        if a.size == 1:
            a, b = b, a
        b = _api.repeat_layer(b, a.size)
    return _api.mixed_layer(size=a.size,
                            input=[_api.identity_projection(a),
                                   _api.identity_projection(b)])


def _sub(a, b):
    if isinstance(b, (int, float)):
        return _api.slope_intercept_layer(input=a, slope=1.0, intercept=-b)
    return _add(a, _api.slope_intercept_layer(input=b, slope=-1.0,
                                              intercept=0.0))


def _rsub(a, b):
    return _add(_api.slope_intercept_layer(input=a, slope=-1.0,
                                           intercept=0.0), b)


def _mul(a, b):
    if isinstance(b, (int, float)):
        return _api.slope_intercept_layer(input=a, slope=b, intercept=0.0)
    if not isinstance(b, LayerOutput):
        raise ConfigError("LayerOutput * needs a LayerOutput or a number")
    if a.size == 1:
        return _api.scaling_layer(input=b, weight=a)
    if b.size == 1:
        return _api.scaling_layer(input=a, weight=b)
    raise ConfigError("'*' needs a number or a size-1 LayerOutput operand")


LayerOutput.__add__ = _add
LayerOutput.__radd__ = _add
LayerOutput.__sub__ = _sub
LayerOutput.__rsub__ = _rsub
LayerOutput.__mul__ = _mul
LayerOutput.__rmul__ = _mul
