"""paddle.v2.optimizer (``paddle_tpu/v2/optimizer.py``; reference
v2/optimizer.py): class-style ctors over the optimizer suite, taking
the reference's regularization and clipping keywords."""

from paddle_tpu_torch.optim import (AdaDelta, AdaGrad, AdaMax, Adam,
                                    DecayedAdaGrad, Momentum, RMSProp)


def _with_reg(ctor):
    def make(learning_rate=1e-3, regularization=None,
             gradient_clipping_threshold=None, model_average=None, **kw):
        if regularization:
            kw.setdefault("l2", regularization.get("l2", 0.0))
            kw.setdefault("l1", regularization.get("l1", 0.0))
        if gradient_clipping_threshold:
            kw.setdefault("clip_threshold", gradient_clipping_threshold)
        return ctor(learning_rate=learning_rate, **kw)
    return make


Momentum = _with_reg(Momentum)
Adam = _with_reg(Adam)
AdaGrad = _with_reg(AdaGrad)
AdaDelta = _with_reg(AdaDelta)
RMSProp = _with_reg(RMSProp)
DecayedAdaGrad = _with_reg(DecayedAdaGrad)
AdaMax = _with_reg(AdaMax)


def L2Regularization(rate):
    """paddle.v2.optimizer.L2Regularization(rate=...)"""
    return {"l2": rate}


def L1Regularization(rate):
    return {"l1": rate}
