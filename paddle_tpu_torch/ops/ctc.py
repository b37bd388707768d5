"""CTC loss and best-path decode (``paddle_tpu/ops/ctc.py``; reference
CTCLayer + LinearChainCTC and WarpCTCLayer).

One implementation: the alpha recursion over the extended label
sequence (blanks interleaved) in log space, a loop over time vectorized
over the batch and the label positions, where JAX runs a ``lax.scan``;
autograd supplies the gradient.  Blank is 0 unless given (the layers
pass theirs).  In JAX these are XLA's ops, so on the card they run as
PyTorch's.
"""

import torch
import torch.nn.functional as F

_NEG = -1e30


def ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank=0):
    """Per-sample CTC negative log-likelihood: log_probs [B, T, C]
    (log-softmax outputs), logit_lengths [B], labels int [B, L] (padded
    with anything), label_lengths [B] -> [B]."""
    b, t, c = log_probs.shape
    s = 2 * labels.shape[1] + 1   # blank label blank label ... blank
    dev = log_probs.device
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = torch.clamp(labels.long(), 0, c - 1)
    # alpha[s] may come from s-2 where ext[s] is no blank and differs
    # from ext[s-2]
    can_skip = (ext != blank) & (ext != F.pad(ext[:, :-2], (2, 0), value=-1))
    valid = torch.arange(s, device=dev)[None, :] < (
        2 * label_lengths[:, None] + 1)
    label_lengths = label_lengths.long()

    def emit(ti):
        return log_probs[:, ti].gather(1, ext)        # [B, S]

    e0 = emit(0)
    alpha = torch.full_like(e0, _NEG)
    alpha[:, 0] = e0[:, 0]
    if s > 1:
        alpha[:, 1] = torch.where(label_lengths > 0, e0[:, 1], _NEG)
    alpha = torch.where(valid, alpha, _NEG)
    for ti in range(1, t):
        prev1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG)
        prev2 = torch.where(can_skip,
                            F.pad(alpha[:, :-2], (2, 0), value=_NEG), _NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) \
            + emit(ti)
        merged = torch.where(valid, merged, _NEG)
        # frozen past the logit length
        alpha = torch.where((ti < logit_lengths)[:, None], merged, alpha)
    last = 2 * label_lengths                          # the final blank
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, _NEG)
    return -torch.logaddexp(a_last, a_prev)


def ctc_greedy_decode(log_probs, logit_lengths, blank=0):
    """Best-path decode: argmax per step, collapse repeats, drop blanks.
    Returns (ids [B, T] int32 padded with -1, lengths [B] int32)."""
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)      # [B, T]
    b, t = ids.shape
    in_range = torch.arange(t, device=ids.device)[None, :] \
        < logit_lengths[:, None]
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    keep = (ids != blank) & (ids != prev) & in_range
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    rows = torch.arange(b, device=ids.device)[:, None].expand(b, t)
    out = torch.full_like(ids, -1)
    out[rows[keep], pos[keep].long()] = ids[keep]
    return out, keep.sum(dim=1).to(torch.int32)
