"""Embedding lookup and one-hot rows (``paddle_tpu/ops/embedding.py``)."""

import torch


def embedding_lookup(table, ids):
    """table [vocab, dim], integer ids [...] -> [..., dim].  Out-of-range
    ids (e.g. padding -1) give exact zero rows."""
    valid = (ids >= 0) & (ids < table.shape[0])
    safe = torch.clamp(ids, 0, table.shape[0] - 1).long()
    out = table[safe]
    return out * valid[..., None].to(out.dtype)


def one_hot(ids, depth, dtype=torch.float32):
    """Integer ids [...] -> [..., depth] one-hot rows; out-of-range ids
    (padding) give all-zero rows, as ``embedding_lookup``'s do."""
    return (ids[..., None] == torch.arange(depth, device=ids.device)) \
        .to(dtype)
