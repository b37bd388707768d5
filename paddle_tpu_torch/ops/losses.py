"""Cost ops (``paddle_tpu/ops/losses.py``; reference CostLayer).  Each
returns a per-sample loss [B]; callers mean over the batch.  Only the
multi-class cross-entropy and the per-sequence mean of the training
slices are ported (ROADMAP)."""

import torch

_EPS = 1e-10


def classification_cost(logits_or_probs, label_ids, *, from_logits=True):
    """Multi-class CE with integer labels (reference MultiClassCrossEntropy);
    labels are clipped to [0, C-1]."""
    if from_logits:
        logp = torch.log_softmax(logits_or_probs, dim=-1)
    else:
        logp = torch.log(torch.clamp(logits_or_probs, min=_EPS))
    ids = torch.clamp(label_ids.long(), 0, logp.shape[-1] - 1)
    return -torch.gather(logp, -1, ids[..., None])[..., 0]


def masked_seq_mean(per_token_loss, mask):
    """Average a [B, T] per-token loss over valid tokens, per sample."""
    tot = (per_token_loss * mask).sum(-1)
    return tot / torch.clamp(mask.sum(-1), min=1.0)
