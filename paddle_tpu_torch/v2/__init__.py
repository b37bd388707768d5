"""paddle.v2-compatible namespace (``paddle_tpu/v2``).

Reference: python/paddle/v2/ (layer.py, trainer.py:30 SGD, parameters.py,
optimizer.py, event.py, inference.py, reader/, dataset/, minibatch.py).
A reference user's ``import paddle.v2 as paddle`` script maps to
``import paddle_tpu_torch.v2 as paddle`` with the same module shapes:

    paddle.init(use_gpu=False, trainer_count=1)   # use_gpu=False: the CPU
    y = paddle.layer.fc(input=x, size=10, act=...)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost, params, paddle.optimizer.Adam(...))
    trainer.train(reader=paddle.batch(paddle.dataset.mnist.train(), 128),
                  event_handler=..., num_passes=5)

It runs on the card unless ``init(use_gpu=False)`` (``FLAGS.use_gpu``)
or a ``device="cpu"`` argument asks for the CPU.
"""

import importlib as _importlib

from paddle_tpu_torch.trainer.api import init
from paddle_tpu_torch.v2.inference import infer
from paddle_tpu_torch.v2 import config_base, minibatch, topology  # noqa: F401

from paddle_tpu_torch.v2 import layer
from paddle_tpu_torch.v2 import activation
from paddle_tpu_torch.v2 import pooling
from paddle_tpu_torch.v2 import attr
from paddle_tpu_torch.v2 import networks
from paddle_tpu_torch.v2 import optimizer
from paddle_tpu_torch.v2 import parameters
from paddle_tpu_torch.v2 import trainer
from paddle_tpu_torch.v2 import event
from paddle_tpu_torch.v2 import inference
from paddle_tpu_torch.v2 import reader
from paddle_tpu_torch.v2 import dataset
from paddle_tpu_torch.v2 import evaluator
from paddle_tpu_torch.v2 import plot
from paddle_tpu_torch.data import feeder as data_feeder
# paddle_tpu_torch.data binds the name ``provider`` to the decorator
# function, which shadows the submodule for ``import ... as``: the module
# comes from sys.modules instead
data_type = _importlib.import_module("paddle_tpu_torch.data.provider")

# paddle.batch is minibatch.batch (one definition, two reference names)
batch = minibatch.batch


__all__ = ["init", "infer", "batch", "layer", "activation", "pooling",
           "attr", "networks", "optimizer", "parameters", "trainer",
           "event", "inference", "reader", "dataset", "evaluator",
           "data_feeder", "data_type"]
