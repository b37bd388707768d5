"""paddle.v2.attr (``paddle_tpu/v2/attr.py``): ParamAttr / ExtraAttr
(reference v2/attr.py wrapping trainer_config_helpers/attrs.py).  Layer
ctors accept plain dicts; these helpers build them."""


def Param(name=None, initial_std=None, initial_mean=None, learning_rate=None,
          l2_rate=None, l1_rate=None, is_static=False, initial_strategy=None,
          **kw):
    d = {}
    if name is not None:
        d["name"] = name
    if initial_std is not None:
        d["initial_std"] = initial_std
    if initial_mean is not None:
        d["initial_mean"] = initial_mean
    if initial_strategy is not None:
        d["initial_strategy"] = initial_strategy
    if learning_rate is not None:
        d["learning_rate"] = learning_rate
    if l2_rate is not None:
        d["l2_rate"] = l2_rate
    if l1_rate is not None:
        d["l1_rate"] = l1_rate
    if is_static:
        d["is_static"] = True
    d.update(kw)
    return d


ParamAttr = Param


def Extra(drop_rate=None, **kw):
    d = {}
    if drop_rate is not None:
        d["drop_rate"] = drop_rate
    d.update(kw)
    return d


ExtraAttr = ExtraLayerAttribute = Extra

from paddle_tpu_torch.compat.v1 import HookAttribute  # noqa: E402

Hook = HookAttr = HookAttribute
