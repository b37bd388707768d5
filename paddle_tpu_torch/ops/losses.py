"""Cost ops (``paddle_tpu/ops/losses.py``; reference
gserver/layers/CostLayer.{h,cpp}): MSE (square error), multi-class
cross-entropy and its self-normalized variant, binary CE against soft
targets and over multi-hot labels, two-class CE, the pairwise rank cost,
LambdaRank, huber (regression and two-class), smooth-L1 and the sum
cost.  The structured losses live in ``crf.py`` and ``ctc.py``.

Each takes [B, ...] and returns a per-sample loss [B]; callers mean over
the batch.  Autograd supplies the backward, as JAX's autodiff does."""

import math

import torch
import torch.nn.functional as F

_EPS = 1e-10


def _softplus(x):
    """log(1 + exp(x)) as JAX's ``jnp.logaddexp(0, x)``."""
    return torch.logaddexp(torch.zeros_like(x), x)


def square_error(pred, label):
    """MSE (reference SumOfSquaresCostLayer): 0.5 * ||pred - label||^2."""
    d = pred - label
    return 0.5 * (d * d).sum(-1)


def classification_cost(logits_or_probs, label_ids, *, from_logits=True):
    """Multi-class CE with integer labels (reference MultiClassCrossEntropy);
    labels are clipped to [0, C-1]."""
    if from_logits:
        logp = torch.log_softmax(logits_or_probs, dim=-1)
    else:
        logp = torch.log(torch.clamp(logits_or_probs, min=_EPS))
    ids = torch.clamp(label_ids.long(), 0, logp.shape[-1] - 1)
    return -torch.gather(logp, -1, ids[..., None])[..., 0]


def cross_entropy_with_selfnorm(logits, label_ids, alpha=0.1):
    """Reference MultiClassCrossEntropyWithSelfNorm: CE + alpha log(Z)^2."""
    logz = torch.logsumexp(logits, dim=-1)
    return classification_cost(logits, label_ids) + alpha * logz * logz


def soft_binary_class_cross_entropy(probs, soft_labels):
    """Reference SoftBinaryClassCrossEntropy: the sum over dims of binary
    CE against soft targets; ``probs`` in (0, 1) (a sigmoid first)."""
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return -(soft_labels * torch.log(p)
             + (1 - soft_labels) * torch.log1p(-p)).sum(-1)


def multi_binary_label_cross_entropy(logits, labels):
    """Reference MultiBinaryLabelCrossEntropy: sigmoid CE, multi-hot
    labels."""
    return -(labels * F.logsigmoid(logits)
             + (1 - labels) * F.logsigmoid(-logits)).sum(-1)


def binary_classification_cost(prob, label):
    """Two-class CE on a scalar probability output."""
    p = torch.clamp(prob.reshape(prob.shape[0]), _EPS, 1 - _EPS)
    y = label.reshape(label.shape[0]).to(p.dtype)
    return -(y * torch.log(p) + (1 - y) * torch.log1p(-p))


def rank_cost(left, right, label, weight=None):
    """Pairwise rank loss (reference RankingCost):
    C = log(1 + exp(o)) - t o, o = left - right, t in {0, 0.5, 1}."""
    o = (left - right).reshape(left.shape[0])
    t = label.reshape(label.shape[0]).to(o.dtype)
    c = _softplus(o) - t * o
    if weight is not None:
        c = c * weight.reshape(weight.shape[0])
    return c


def lambda_cost(scores, relevance, mask, ndcg_num=5):
    """LambdaRank cost over a padded list of documents (reference
    LambdaCost): scores, relevance, mask [B, T] -> [B], the pairwise
    logistic over pairs with rel_i > rel_j weighted by |delta NDCG| (no
    gradient through the weights).  Both sorts are stable, as JAX's."""
    s_i, s_j = scores[:, :, None], scores[:, None, :]
    pair = (relevance[:, :, None] > relevance[:, None, :]) & (
        (mask[:, :, None] * mask[:, None, :]) > 0)
    valid = mask > 0
    # ideal DCG of each list's top ndcg_num, the NDCG normalizer
    topk = torch.sort(torch.where(valid, relevance, -math.inf), dim=-1,
                      descending=True, stable=True).values
    k = min(ndcg_num, scores.shape[-1])
    disc = 1.0 / torch.log2(torch.arange(2, k + 2, device=scores.device)
                            .to(scores.dtype))
    top = topk[:, :k]
    ideal = torch.where(torch.isfinite(top), (2.0 ** top - 1) * disc,
                        0.0).sum(-1)
    ideal = torch.clamp(ideal, min=_EPS)[:, None, None]
    # each document's rank under the current scores, 0 = best
    order = torch.argsort(torch.argsort(
        torch.where(valid, -scores, math.inf), dim=-1, stable=True),
        dim=-1, stable=True)
    d = 1.0 / torch.log2(2.0 + order.to(scores.dtype))
    gain = 2.0 ** relevance - 1.0
    delta_ndcg = torch.abs((gain[:, :, None] - gain[:, None, :])
                           * (d[:, :, None] - d[:, None, :])) / ideal
    w = torch.where(pair, delta_ndcg, 0.0).detach()
    return (w * _softplus(-(s_i - s_j))).sum(dim=(1, 2))


def huber_regression(pred, label, delta=1.0):
    d = torch.abs(pred - label)
    return torch.where(d <= delta, 0.5 * d * d,
                       delta * (d - 0.5 * delta)).sum(-1)


def huber_classification(pred, label):
    """Reference HuberTwoClassification: labels {0, 1} -> y in {-1, 1}."""
    y = (2.0 * label.reshape(label.shape[0]) - 1.0).to(pred.dtype)
    a = y * pred.reshape(pred.shape[0])
    return torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, (1.0 - a) ** 2, 0.0))


def smooth_l1(pred, label):
    d = pred - label
    ad = torch.abs(d)
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)


def sum_cost(x):
    """Reference SumCostLayer: the sum of the input, per sample."""
    return x.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x


def masked_seq_mean(per_token_loss, mask):
    """Average a [B, T] per-token loss over valid tokens, per sample."""
    tot = (per_token_loss * mask).sum(-1)
    return tot / torch.clamp(mask.sum(-1), min=1.0)
