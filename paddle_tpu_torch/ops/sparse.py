"""Sparse-row embedding machinery, the large-vocab path
(``paddle_tpu/ops/sparse.py``; reference math/SparseRowMatrix.h:204,
trainer/RemoteParameterUpdater.h:265).

The rows a batch touches are gathered into a [K, D] block; the train
step differentiates that block in place of the [V, D] table, updates it
and scatters it back, so the gradient, the optimizer and the write-back
cost O(K D) whatever the vocabulary.  ``unique_touched`` keeps JAX's
static shapes: a sorted id list padded with ``vocab`` up to the row
budget K.  ``torch.unique`` has no ``size=``, so its variable-size
result is read on the host (one sync a call) and padded here; a batch
touching more than K distinct ids keeps the K smallest, as JAX's
``jnp.unique(size=K)`` does.  JAX drops the fill slots' writes
(``mode="drop"``); torch's indexed writes do not drop, so
``scatter_rows`` writes back only the valid prefix of the block.

An id outside [0, vocab) (padding -1, or ``vocab`` itself) reads a zero
row on the dense path (``ops/embedding.embedding_lookup``).  Here it
touches no row: it takes no slot of the block, its ``inv`` is -1, so
the block lookup reads a zero row for it too, and nothing is written
back for it.  JAX keeps -1 as a touched id and its ``mode="drop"``
write wraps it into row vocab - 1 (ROADMAP C19).
"""

import torch


def default_row_budget(n_ids):
    """The row budget for a batch of ``n_ids`` ids: the next power of two
    (JAX's loop, not capped at n_ids)."""
    b = 1
    while b < n_ids:
        b *= 2
    return b


def unique_touched(ids, budget, vocab, with_count=False):
    """ids: integer tensor (any shape) -> (uids [budget], inv ids.shape),
    both int32.  uids lists the distinct ids in [0, vocab) in ascending
    order, the slots past them hold ``vocab``; ``rows[inv]`` equals
    ``table[ids]`` after ``rows = gather_rows(table, uids)`` wherever an
    id is in range, and an id out of range has inv -1.  Past ``budget``
    distinct ids uids keeps the smallest ``budget`` and inv still counts
    on (its positions past the block read as out of range).  with_count
    also returns how many slots of uids are valid, a host int."""
    flat = ids.reshape(-1).to(torch.int32)
    valid = (flat >= 0) & (flat < vocab)
    # every id out of range becomes vocab, which sorts after the rest;
    # one vocab more keeps it the last unique id whatever the batch, so
    # the valid count is the result's size less one, with no second sync
    keyed = torch.cat([torch.where(valid, flat, vocab),
                       flat.new_full((1,), vocab)])
    uniq, inv = torch.unique(keyed, sorted=True, return_inverse=True)
    n = min(int(uniq.numel()) - 1, budget)
    uids = torch.full((budget,), vocab, dtype=torch.int32, device=ids.device)
    uids[:n] = uniq[:n]
    inv = torch.where(valid, inv[:-1], -1).reshape(ids.shape) \
        .to(torch.int32)
    return (uids, inv, n) if with_count else (uids, inv)


def gather_rows(table, uids):
    """[V, D] x [K] -> [K, D]; the fill slots (out of range) read the
    last row, whose value is never consumed and whose update
    ``scatter_rows`` never writes."""
    return table[torch.clamp(uids, 0, table.shape[0] - 1).long()]


def scatter_rows(table, uids, new_rows, count=None):
    """Write the updated rows back into ``table``, in place, and return
    it: only the ``count`` valid slots of uids (its ids below the table's
    length, counted on the host where ``count`` is None), so a fill slot
    touches nothing."""
    if count is None:
        count = int((uids < table.shape[0]).sum())
    with torch.no_grad():
        table.index_copy_(0, uids[:count].long(), new_rows[:count])
    return table
