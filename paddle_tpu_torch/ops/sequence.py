"""Pooling over the time axis of a padded sequence batch
(``paddle_tpu/ops/sequence.py``; reference SequencePoolLayer family).
Padding never leaks into a result: max pools pad at -1e30 and an empty
sequence pools to 0.  The other sequence ops are not ported yet
(ROADMAP)."""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch

_NEG = -1e30


def seq_max_pool(seq: SequenceBatch):
    """[B, T, D] -> [B, D] max over valid steps (reference MaxLayer)."""
    m = seq.mask(seq.data.dtype)[..., None]
    out = torch.where(m > 0, seq.data, _NEG).max(dim=1).values
    any_valid = (seq.lengths > 0)[:, None]
    return torch.where(any_valid, out, 0.0)


def seq_avg_pool(seq: SequenceBatch):
    """Average over valid steps (reference AverageLayer 'average')."""
    s = seq_sum_pool(seq)
    n = torch.clamp(seq.lengths.to(s.dtype), min=1.0)[:, None]
    return s / n


def seq_sum_pool(seq: SequenceBatch):
    """Sum over valid steps (reference AverageLayer 'sum')."""
    return (seq.data * seq.mask(seq.data.dtype)[..., None]).sum(dim=1)


def seq_sqrt_pool(seq: SequenceBatch):
    """sum / sqrt(len) (reference AverageLayer 'squarerootn')."""
    s = seq_sum_pool(seq)
    n = torch.sqrt(torch.clamp(seq.lengths.to(s.dtype), min=1.0))[:, None]
    return s / n


def seq_last(seq: SequenceBatch):
    """Last valid step (reference SequenceLastInstanceLayer); step 0 for
    an empty sequence."""
    idx = torch.clamp(seq.lengths.long() - 1, min=0)
    return seq.data[torch.arange(seq.batch_size, device=idx.device), idx]


def seq_first(seq: SequenceBatch):
    """First step (reference first_seq)."""
    return seq.data[:, 0]


def seq_pool(seq: SequenceBatch, pooling: str):
    return {
        "max": seq_max_pool,
        "avg": seq_avg_pool,
        "average": seq_avg_pool,
        "sum": seq_sum_pool,
        "sqrt": seq_sqrt_pool,
        "last": seq_last,
        "first": seq_first,
    }[pooling](seq)
