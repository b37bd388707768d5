"""``from paddle.trainer_config_helpers import *`` during a port parse:
the surface every reference v1 config script imports (reference
python/paddle/trainer_config_helpers/__init__.py re-exporting layers,
networks, activations, poolings, attrs, optimizers, data_sources and
evaluators), the port's twin of the repository's root
``paddle/trainer_config_helpers``.

The layer ctors come from ``paddle_tpu_torch.layers``, each adapted to
take ``layer_attr=``.  A few are wrapped to record into the active parse
context (``compat.config_parser``): ``data_layer`` notes the declaration
order and takes seq-ness from the data provider's ``input_types`` (the
reference's rule: seq-ness lives in the provider, not the layer
config), and ``outputs()`` / ``inputs()`` / every ``*_evaluator``
register what the trainer optimizes, feeds and tracks.
"""

import inspect as _inspect

from paddle_tpu_torch.layers import *              # noqa: F401,F403
import paddle_tpu_torch.layers as _L
from paddle_tpu_torch.layers import layer_math     # noqa: F401
import paddle_tpu_torch.evaluators as _E
from paddle_tpu_torch.compat import config_parser as _cp
from paddle_tpu_torch.compat.v1 import *           # noqa: F401,F403
from paddle_tpu_torch.data.provider import SeqType as _SeqType


def _adapt_layer_attr(ctor):
    """v1 configs pass layer_attr=ExtraAttr(...) to nearly every ctor;
    for a ctor without that keyword, the attr dict is merged into the
    node's cfg after construction (drop_rate etc. are read from the cfg
    at apply time)."""
    try:
        sig = _inspect.signature(ctor)
    except (TypeError, ValueError):
        return ctor
    if "layer_attr" in sig.parameters or any(
            p.kind == _inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()):
        return ctor

    def wrapped(*a, **kw):
        la = kw.pop("layer_attr", None)
        node = ctor(*a, **kw)
        if la and hasattr(node, "cfg"):
            node.cfg.update(la)
        return node
    wrapped.__name__ = getattr(ctor, "__name__", "layer")
    wrapped.__doc__ = ctor.__doc__
    return wrapped


for _name in dir(_L):
    if _name.startswith("_"):
        continue
    _obj = getattr(_L, _name)
    if callable(_obj) and not isinstance(_obj, type) and getattr(
            _obj, "__module__", "").startswith("paddle_tpu_torch.layers"):
        globals()[_name] = _adapt_layer_attr(_obj)
del _name, _obj


def data_layer(name, size, is_seq=False, height=None, width=None, **_kw):
    """data_layer whose seq-ness comes from the provider's declared
    input_types while a config parses (PyDataProvider2 owns the
    distinction); the declaration order is recorded for positional
    input_types."""
    if _cp.in_parse():
        ctx = _cp.active_context()
        types = _cp.resolve_input_types(ctx)
        itype = None
        if isinstance(types, dict):
            itype = types.get(name)
        elif isinstance(types, (list, tuple)):
            idx = len(ctx.input_order)
            if idx < len(types):
                itype = types[idx]
        if itype is not None and itype.seq_type != _SeqType.NO_SEQUENCE:
            is_seq = True
        ctx.input_order.append(name)
    return _L.data_layer(name, size, is_seq=is_seq, height=height,
                         width=width)


def outputs(layers, *args):
    """outputs(): records the output layers on the parse context."""
    out = list(layers if isinstance(layers, (list, tuple)) else [layers])
    out += list(args)
    if _cp.in_parse():
        _cp.active_context().outputs = out
    return out[0] if len(out) == 1 else out


def inputs(layers, *args):
    """inputs(): an explicit data-layer order, which wins over the
    outputs-derived DFS order (the reference's HasInputsSet)."""
    ins = list(layers if isinstance(layers, (list, tuple)) else [layers])
    ins += list(args)
    if _cp.in_parse():
        ctx = _cp.active_context()
        ctx.input_order = [layer.name for layer in ins]
        ctx.explicit_inputs = True
    return None


def _wrap_evaluator(ctor):
    def wrapped(*a, **kw):
        spec = ctor(*a, **kw)
        if _cp.in_parse():
            _cp.active_context().evaluators.append(spec)
        return spec
    wrapped.__name__ = ctor.__name__
    wrapped.__doc__ = ctor.__doc__
    return wrapped


for _n in [n for n in _E.__all__ if n.endswith("_evaluator")]:
    globals()[_n] = _wrap_evaluator(getattr(_E, _n))
del _n
