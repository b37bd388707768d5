"""Decoding search (``paddle_tpu/ops/beam.py``; reference
RecurrentGradientMachine's generation).  Only ``greedy_search`` (the
reference's oneWaySearch) is ported; ``beam_search`` waits for ROADMAP
A10."""

import torch

from paddle_tpu_torch.utils.tree import tree_leaves


def greedy_search(step_fn, init_state, batch_size, max_len, bos_id, eos_id):
    """Argmax decode for ``max_len`` steps (``beam.py:119-136``).

    ``step_fn(state, prev_ids [B] int32) -> (log_probs [B, V], state)``.
    A row that has emitted ``eos_id`` keeps emitting it.  Returns (tokens
    [B, max_len] int32, lengths [B] int32: tokens before the first
    eos)."""
    dev = tree_leaves(init_state)[0].device
    i32 = torch.int32
    state = init_state
    prev = torch.full((batch_size,), bos_id, dtype=i32, device=dev)
    tokens = torch.full((batch_size, max_len), eos_id, dtype=i32, device=dev)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((batch_size,), dtype=i32, device=dev)
    eos = torch.tensor(eos_id, dtype=i32, device=dev)
    for t in range(max_len):
        log_probs, state = step_fn(state, prev)
        nxt = torch.argmax(log_probs, dim=-1).to(i32)
        nxt = torch.where(finished, eos, nxt)
        tokens[:, t] = nxt
        lengths = torch.where(finished | (nxt == eos_id), lengths,
                              lengths + 1)
        finished = finished | (nxt == eos_id)
        prev = nxt
    return tokens, lengths
