"""paddle.v2.activation (``paddle_tpu/v2/activation.py``): class-style
activation markers (reference v2/activation.py wrapping
trainer_config_helpers/activations.py).  The layer ctors take act=
strings, so these markers are their names."""


class _Act(str):
    def __new__(cls, name):
        return str.__new__(cls, name)


Tanh = _Act("tanh")
Sigmoid = _Act("sigmoid")
Softmax = _Act("softmax")
SequenceSoftmax = _Act("sequence_softmax")
Relu = _Act("relu")
BRelu = _Act("brelu")
SoftRelu = _Act("softrelu")
STanh = _Act("stanh")
Abs = _Act("abs")
Square = _Act("square")
Exp = _Act("exponential")
Log = _Act("log")
Linear = Identity = _Act("")


def __getattr__(name):
    raise AttributeError(f"unknown activation {name!r}")
