"""Linear-chain CRF: the negative log-likelihood and Viterbi decode
(``paddle_tpu/ops/crf.py``; reference CRFLayer + LinearChainCRF,
CRFDecodingLayer).

The parameter keeps the reference's [N+2, N] layout, so checkpoints
carry across: row 0 the start transitions, row 1 the end transitions,
rows 2.. the transitions w[i][j] from tag i to tag j.  JAX's
``lax.scan``s over time are loops over time here: the alpha recursion
with logsumexp carries, Viterbi with max / argmax carries (the first
maximum, as ``jnp.argmax``) and a reverse traceback in which padding
steps point at themselves, so the path freezes past a sequence's end.
Autograd supplies the partition function's gradient.  In JAX these are
XLA's ops with no Pallas kernel behind them, so on the card they run as
PyTorch's, a few small launches a time step.
"""

import torch


def _split_params(w):
    """w [N+2, N] -> (start [N], end [N], trans [N, N])."""
    return w[0], w[1], w[2:]


def _mask(lengths, t):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def crf_path_score(emissions, tags, lengths, w):
    """The score of the tag path ``tags`` [B, T] over each sequence's
    valid steps: start + emissions + transitions + end, [B] (the gold
    score of ``crf_log_likelihood``; tags clipped to [0, N-1])."""
    start, end, trans = _split_params(w)
    n = emissions.shape[-1]
    mask = _mask(lengths, emissions.shape[1]).to(emissions.dtype)
    tags = torch.clamp(tags.long(), 0, n - 1)
    emit = (emissions.gather(-1, tags[..., None])[..., 0] * mask).sum(-1)
    moves = (trans[tags[:, :-1], tags[:, 1:]] * mask[:, 1:]).sum(-1)
    last = torch.clamp(lengths.long() - 1, min=0)
    last_tag = tags.gather(1, last[:, None])[:, 0]
    return emit + moves + start[tags[:, 0]] + end[last_tag]


def crf_log_likelihood(emissions, tags, lengths, w):
    """Negative log-likelihood per sequence: emissions [B, T, N]
    unnormalized scores (the layer's raw output), tags int [B, T],
    lengths [B], w [N+2, N] -> [B] log Z - score(tags)."""
    start, end, trans = _split_params(w)
    mask = _mask(lengths, emissions.shape[1])
    alpha = start[None, :] + emissions[:, 0]
    for s in range(1, emissions.shape[1]):
        # alpha'_j = logsumexp_i(alpha_i + trans_ij) + emit_j
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emissions[:, s]
        alpha = torch.where(mask[:, s, None], new, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=-1)
    return log_z - crf_path_score(emissions, tags, lengths, w)


def crf_decode(emissions, lengths, w):
    """Viterbi decode -> (tags [B, T] int32, zero past each length;
    best_score [B])."""
    start, end, trans = _split_params(w)
    b, t, n = emissions.shape
    mask = _mask(lengths, t)
    own = torch.arange(n, device=emissions.device)[None, :]
    delta = start[None, :] + emissions[:, 0]
    pointers = []
    for s in range(1, t):
        scores = delta[:, :, None] + trans[None]          # [B, N, N]
        best_prev = torch.argmax(scores, dim=1)
        m = mask[:, s, None]
        delta = torch.where(m, scores.amax(dim=1) + emissions[:, s], delta)
        # at padding the traceback points to itself: the path freezes
        pointers.append(torch.where(m, best_prev, own))
    final = delta + end[None, :]
    tag = torch.argmax(final, dim=-1)
    path = [tag]
    for bp in reversed(pointers):
        tag = bp.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    tags = torch.stack(path[::-1], dim=1)
    return (tags * mask).to(torch.int32), final.amax(dim=-1)
