"""Large-vocabulary sampled losses: NCE and the hierarchical sigmoid
(``paddle_tpu/ops/sampling.py``; reference NCELayer with
MultinomialSampler, HierarchicalSigmoidLayer with MatrixBitCode.cpp).

The JAX package leaves them to XLA (gathers and small dense products),
so they are PyTorch calls here.  Every draw comes from an explicit
``torch.Generator`` (its device is where the draws are made), so the
bits are PyTorch's, not JAX's: ``nce_loss`` takes its negative ids
drawn beforehand, which makes its value a function of those ids alone.
"""

import math

import torch
import torch.nn.functional as F


def uniform_neg_samples(generator, shape, num_classes):
    """Ids uniform in [0, num_classes) of ``shape``, int32, drawn from
    ``generator`` on its device."""
    return torch.randint(0, num_classes, tuple(shape), generator=generator,
                         device=generator.device).to(torch.int32)


def nce_loss(x, w, b, labels, neg_samples, num_classes, sample_probs=None):
    """Noise-contrastive estimation loss [B].

    x [B, D] features; w [V, D] class embeddings; b [V]; labels int [B];
    neg_samples int [B, K] (drawn beforehand).  The binary CE of the
    true class as positive and the K noise ids as negatives, each logit
    corrected by log(K * P_n(id)) (uniform P_n = 1 / num_classes unless
    ``sample_probs`` [V])."""
    k = neg_samples.shape[1]
    if sample_probs is None:
        corr_all = math.log(float(k)) - math.log(float(num_classes))
    else:
        corr_all = math.log(float(k)) + torch.log(
            torch.clamp(sample_probs, min=1e-20))

    def logit(ids):
        ids = ids.long()
        s = torch.einsum("bd,bkd->bk", x, w[ids]) + b[ids]
        corr = corr_all if sample_probs is None else corr_all[ids]
        return s - corr

    pos = logit(labels[:, None])[:, 0]
    neg = logit(neg_samples)
    return -F.logsigmoid(pos) - F.logsigmoid(-neg).sum(dim=-1)


def _bit_codes(labels, code_len):
    """The reference's Huffman-free binary codes (MatrixBitCode.cpp):
    class c's path visits internal nodes ((c+1) >> (d+1)) - 1 with branch
    bit ((c+1) >> d) & 1, d = 0..code_len-1, while the node index is >= 0.
    Returns (nodes clamped to >= 0, bits float32, valid) each [..., L]."""
    c1 = labels.long()[..., None] + 1
    ds = torch.arange(code_len, device=labels.device)
    nodes = (c1 >> (ds + 1)) - 1
    bits = (c1 >> ds) & 1
    valid = nodes >= 0
    return torch.clamp(nodes, min=0), bits.to(torch.float32), valid


def hsigmoid_loss(x, w, b, labels, num_classes):
    """Hierarchical sigmoid loss [B] (reference HierarchicalSigmoidLayer)
    over the ceil(log2 V) nodes of each label's path.

    x [B, D]; w [V-1, D] internal-node weights; b [V-1]; labels int [B].
    Each node costs log(1 + exp(s)) - bit * s; the invalid nodes of a
    short path read row 0 and are masked out, so they add nothing to its
    gradient.  ``torch.logaddexp(0, s)`` as JAX writes it: ``F.softplus``
    turns into the identity above its threshold."""
    code_len = max(1, math.ceil(math.log2(max(num_classes, 2))))
    nodes, bits, valid = _bit_codes(labels, code_len)
    s = torch.einsum("bd,bld->bl", x, w[nodes]) + b[nodes]
    loss = torch.logaddexp(torch.zeros_like(s), s) - bits * s
    return (loss * valid.to(loss.dtype)).sum(dim=-1)


def multinomial_alias_sample(generator, probs, shape):
    """Ids drawn from ``probs`` [..., V] (floored at 1e-20, not
    necessarily summing to 1), int32 of ``shape`` (reference
    MultinomialSampler), with JAX categorical's broadcasting: the
    trailing dims of ``shape`` are probs' batch dims.  Drawn from
    ``generator``, on its device."""
    v = probs.shape[-1]
    rows = torch.clamp(probs.detach().float(), min=1e-20).reshape(-1, v)
    n = math.prod(shape) // rows.shape[0]
    ids = torch.multinomial(rows.to(generator.device), n, replacement=True,
                            generator=generator)
    return ids.t().reshape(tuple(shape)).to(torch.int32)


def top_k(x, k):
    """The k largest values along the last axis and their ids, int32
    (reference hl_top_k.cu / Matrix::rowMax), ties lowest id first as
    ``lax.top_k`` breaks them (a stable descending sort: ``torch.topk``
    promises no order among ties on CUDA)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k].to(torch.int32)
