"""The v1 ``trainer_config_helpers`` names for unchanged config scripts
(``paddle_tpu/compat/v1.py``; reference
python/paddle/trainer_config_helpers/{activations,attrs,poolings,
optimizers,data_sources}.py).

- Activation classes subclass ``str`` with their registry value, so
  ``fc_layer(act=SoftmaxActivation())`` flows through the layer DSL,
  which looks activations up by string.
- ParameterAttribute / ExtraLayerAttribute subclass ``dict``, matching
  the DSL's ``param_attr`` / ``layer_attr`` dicts.
- Pooling classes carry ``.name`` (``pooling_layer`` reads it).
- The optimizer and regularization classes and ``settings()`` record
  into the active parse context (``compat.config_parser``), as the
  reference's settings(...) fills a global trainer proto.
"""

__all__ = [
    # activations
    "BaseActivation", "TanhActivation", "SigmoidActivation",
    "SoftmaxActivation", "IdentityActivation", "LinearActivation",
    "SequenceSoftmaxActivation", "ExpActivation", "ReluActivation",
    "BReluActivation", "SoftReluActivation", "STanhActivation",
    "AbsActivation", "SquareActivation", "LogActivation",
    # attrs
    "ParameterAttribute", "ParamAttr", "ExtraLayerAttribute", "ExtraAttr",
    "HookAttribute", "HookAttr",
    # poolings
    "BasePoolingType", "MaxPooling", "AvgPooling", "SumPooling",
    "SquareRootNPooling", "CudnnMaxPooling", "CudnnAvgPooling",
    "MaxWithIdPooling",
    # optimizers / settings
    "BaseSGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "AdaGradOptimizer", "DecayedAdaGradOptimizer",
    "AdaDeltaOptimizer", "RMSPropOptimizer", "settings",
    "BaseRegularization", "L2Regularization", "L1Regularization",
    "ModelAverage", "GradientClippingThreshold",
    # data sources + config args
    "define_py_data_sources2", "define_py_data_sources", "get_config_arg",
    "get_batch_size",
]


# ------------------------------------------------------------- activations

class BaseActivation(str):
    """str subclass: instances ARE the activation-registry key."""
    _value = ""

    def __new__(cls):
        return str.__new__(cls, cls._value)

    @property
    def name(self):
        return str(self)


def _act(name, value):
    cls = type(name, (BaseActivation,), {"_value": value})
    return cls


TanhActivation = _act("TanhActivation", "tanh")
SigmoidActivation = _act("SigmoidActivation", "sigmoid")
SoftmaxActivation = _act("SoftmaxActivation", "softmax")
IdentityActivation = _act("IdentityActivation", "linear")
LinearActivation = IdentityActivation
SequenceSoftmaxActivation = _act("SequenceSoftmaxActivation",
                                 "sequence_softmax")
ExpActivation = _act("ExpActivation", "exponential")
ReluActivation = _act("ReluActivation", "relu")
BReluActivation = _act("BReluActivation", "brelu")
SoftReluActivation = _act("SoftReluActivation", "softrelu")
STanhActivation = _act("STanhActivation", "stanh")
AbsActivation = _act("AbsActivation", "abs")
SquareActivation = _act("SquareActivation", "square")
LogActivation = _act("LogActivation", "log")


# ------------------------------------------------------------------- attrs

class ParameterAttribute(dict):
    """Reference attrs.py ParameterAttribute -> the DSL's param_attr dict."""

    def __init__(self, name=None, is_static=False, initial_std=None,
                 initial_mean=None, initial_max=None, initial_min=None,
                 l1_rate=None, l2_rate=None, learning_rate=None,
                 momentum=None, gradient_clipping_threshold=None,
                 sparse_update=False, initial_strategy=0,
                 update_hooks=None):
        d = {}
        if name is not None:
            d["name"] = name
        if initial_std is not None:
            d["initial_std"] = initial_std
        if initial_mean is not None:
            d["initial_mean"] = initial_mean
        if initial_max is not None and initial_min is not None:
            # uniform in [min, max]
            d["initial_strategy"] = 1
            d["initial_std"] = (initial_max - initial_min) / 2.0
            d["initial_mean"] = (initial_max + initial_min) / 2.0
        if initial_strategy:
            d["initial_strategy"] = initial_strategy
        if is_static:
            d["is_static"] = True
        if l1_rate is not None:
            d["l1_rate"] = l1_rate
        if l2_rate is not None:
            d["l2_rate"] = l2_rate
        if learning_rate is not None:
            d["learning_rate"] = learning_rate
        if momentum is not None:
            d["momentum"] = momentum
        if gradient_clipping_threshold is not None:
            d["gradient_clipping_threshold"] = gradient_clipping_threshold
        if sparse_update:
            d["sparse_update"] = True
        if update_hooks is not None:
            d["update_hooks"] = update_hooks
        super().__init__(d)

    @staticmethod
    def to_bias(bias_attr):
        if isinstance(bias_attr, ParameterAttribute):
            return bias_attr
        return False if bias_attr is False else bias_attr


ParamAttr = ParameterAttribute


class ExtraLayerAttribute(dict):
    """Reference ExtraLayerAttribute -> layer_attr dict merged into cfg."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        d = {}
        if drop_rate is not None:
            d["drop_rate"] = drop_rate
        if error_clipping_threshold is not None:
            d["error_clipping_threshold"] = error_clipping_threshold
        # device placement is the runtime's; accepted and ignored
        super().__init__(d)

    @staticmethod
    def to_kwargs(attr):
        return dict(attr) if attr else {}


ExtraAttr = ExtraLayerAttribute


class HookAttribute(dict):
    """Static pruning hook (reference ParameterUpdaterHook.cpp:36).

    sparsity_ratio=r prunes the r fraction of smallest-|w| weights at init;
    mask_filename loads the reference's packed-bit mask file.  Attach via
    ParameterAttribute(update_hooks=...); the trainer masks the parameter
    value at init and its gradient every step (trainer/hooks.py)."""

    def __init__(self, type="pruning", sparsity_ratio=None,
                 mask_filename=None):
        d = dict(type=type)
        if sparsity_ratio is not None:
            if not 0.0 <= sparsity_ratio <= 1.0:
                raise ValueError(
                    f"sparsity_ratio must be in [0, 1], got {sparsity_ratio}")
            d["sparsity_ratio"] = sparsity_ratio
        if mask_filename is not None:
            d["mask_filename"] = mask_filename
        super().__init__(d)


HookAttr = HookAttribute


# ---------------------------------------------------------------- poolings

class BasePoolingType:
    name = "max"

    def __repr__(self):
        return self.name


def _pool(clsname, value):
    # reference pooling types take optional args (MaxPooling
    # (output_max_index=...), SquareRootNPooling()) — accept and ignore
    return type(clsname, (BasePoolingType,),
                {"name": value,
                 "__init__": lambda self, *a, **kw: None})


MaxPooling = _pool("MaxPooling", "max")
CudnnMaxPooling = _pool("CudnnMaxPooling", "max")
AvgPooling = _pool("AvgPooling", "avg")
CudnnAvgPooling = _pool("CudnnAvgPooling", "avg")
SumPooling = _pool("SumPooling", "sum")
SquareRootNPooling = _pool("SquareRootNPooling", "sqrtn")
MaxWithIdPooling = _pool("MaxWithIdPooling", "max")


# ----------------------------------------------- optimizers + settings()

class BaseSGDOptimizer:
    """Carries the reference optimizer name and keywords; lowered to a
    ``paddle_tpu_torch.optim`` optimizer by
    ``config_parser.config_to_runtime``."""

    optim_name = "momentum"

    def __init__(self, **kw):
        self.kw = kw


class MomentumOptimizer(BaseSGDOptimizer):
    optim_name = "momentum"

    def __init__(self, momentum=0.9, sparse=False):
        super().__init__(momentum=momentum)


class AdamOptimizer(BaseSGDOptimizer):
    optim_name = "adam"

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        super().__init__(beta1=beta1, beta2=beta2, epsilon=epsilon)


class AdamaxOptimizer(BaseSGDOptimizer):
    optim_name = "adamax"

    def __init__(self, beta1=0.9, beta2=0.999):
        super().__init__(beta1=beta1, beta2=beta2)


class AdaGradOptimizer(BaseSGDOptimizer):
    optim_name = "adagrad"

    def __init__(self):
        super().__init__()


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    optim_name = "decayed_adagrad"

    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__(rho=rho, epsilon=epsilon)


class AdaDeltaOptimizer(BaseSGDOptimizer):
    optim_name = "adadelta"

    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__(rho=rho, epsilon=epsilon)


class RMSPropOptimizer(BaseSGDOptimizer):
    optim_name = "rmsprop"

    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__(rho=rho, epsilon=epsilon)


class BaseRegularization:
    l1 = 0.0
    l2 = 0.0


class L2Regularization(BaseRegularization):
    def __init__(self, rate):
        self.l2 = rate


class L1Regularization(BaseRegularization):
    def __init__(self, rate):
        self.l1 = rate


class ModelAverage:
    def __init__(self, average_window, max_average_window=None):
        self.average_window = average_window
        self.max_average_window = max_average_window


class GradientClippingThreshold:
    def __init__(self, threshold):
        self.threshold = threshold


def _ctx():
    from paddle_tpu_torch.compat import config_parser
    return config_parser.active_context()


def settings(batch_size=256, learning_rate=1e-3, learning_method=None,
             regularization=None, is_async=False, model_average=None,
             gradient_clipping_threshold=None, learning_rate_decay_a=0.0,
             learning_rate_decay_b=0.0, learning_rate_schedule="poly",
             learning_rate_args="", average_window=0,
             max_average_window=None, **kw):
    """Reference trainer_config_helpers.optimizers.settings -> records the
    optimization config on the active parse context."""
    ctx = _ctx()
    ctx.settings.update(
        batch_size=batch_size, learning_rate=learning_rate,
        learning_method=learning_method or MomentumOptimizer(momentum=0.0),
        regularization=regularization,
        gradient_clipping_threshold=gradient_clipping_threshold,
        learning_rate_decay_a=learning_rate_decay_a,
        learning_rate_decay_b=learning_rate_decay_b,
        learning_rate_schedule=learning_rate_schedule,
        learning_rate_args=learning_rate_args,
        model_average=model_average,
        average_window=average_window,
        max_average_window=max_average_window,
        is_async=is_async)
    ctx.settings.update(kw)


def get_config_arg(name, type_=str, default=None, **_):
    """Reference get_config_arg: typed lookup in --config_args."""
    ctx = _ctx()
    if name not in ctx.config_args:
        return default
    v = ctx.config_args[name]
    if type_ is bool and isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return type_(v)


def get_batch_size():
    return _ctx().settings.get("batch_size", 256)


def define_py_data_sources2(train_list, test_list, module, obj, args=None,
                            train_async=False, data_cls=None):
    """Reference data_sources.define_py_data_sources2: record the provider
    module/obj/args + file lists; the runtime imports the module
    (config dir on sys.path) and drives the @provider reader."""
    ctx = _ctx()
    if isinstance(obj, (list, tuple)):
        train_obj, test_obj = obj
    else:
        train_obj = test_obj = obj
    if isinstance(module, (list, tuple)):
        train_mod, test_mod = module
    else:
        train_mod = test_mod = module
    if isinstance(args, (list, tuple)) and len(args) == 2 and all(
            isinstance(a, dict) for a in args):
        train_args, test_args = args
    else:
        train_args = test_args = args or {}
    if train_list:
        ctx.data_sources["train"] = dict(file_list=train_list,
                                         module=train_mod, obj=train_obj,
                                         args=train_args)
    if test_list:
        ctx.data_sources["test"] = dict(file_list=test_list, module=test_mod,
                                        obj=test_obj, args=test_args)


def define_py_data_sources(train_list, test_list, module, obj, args=None,
                           train_async=False, data_cls=None):
    # the v1 (PyDataProvider1) variant; same recording, providers are
    # expected in PyDataProvider2 style here
    return define_py_data_sources2(train_list, test_list, module, obj, args)
