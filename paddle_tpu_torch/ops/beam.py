"""Decoding search (``paddle_tpu/ops/beam.py``; reference
RecurrentGradientMachine's generation: beamSearch with beamExpand /
beamShrink and its user hooks, and oneWaySearch).

``beam_search`` keeps JAX's static lanes: a batch row holds K lanes, a
finished lane continues with eos at zero cost, and each step's survivors
are the top K of the row's K * V expanded candidates.  It is a Python
loop over ``max_len`` steps on tensors of the state's device; the state
(any tree of tensors, leaves [B*K, ...] lane-major) is reindexed by the
surviving lanes each step with ``index_select``.
"""

from typing import NamedTuple

import torch

from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

_NEG = -1e30
# a candidate at or below this is a dead lane's (-1e30 plus a score)
_DEAD = -1e29


class BeamResult(NamedTuple):
    tokens: torch.Tensor    # [B, K, T] int32 (eos_id-padded after finish)
    scores: torch.Tensor    # [B, K] total log-prob (normalized if asked)
    lengths: torch.Tensor   # [B, K] tokens before (excluding) eos


def _top_k(flat, k):
    """(values, indices) of the k largest entries of each row of ``flat``,
    ties broken lowest index first, as ``lax.top_k`` breaks them (a
    stable descending sort; ``torch.topk`` promises no order among ties
    on CUDA).  Also returns the (k+1)-th value, or None past the row."""
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    nxt = vals[:, k] if flat.shape[1] > k else None
    return vals[:, :k], idx[:, :k], nxt


def beam_search(step_fn, init_state, batch_size, beam_size, max_len, bos_id,
                eos_id, length_penalty=0.0, candidate_adjust=None,
                drop_callback=None, trace=None):
    """``step_fn(state, prev_ids [B*K] int32) -> (log_probs [B*K, V],
    new_state)``; state leaves are [B*K, ...] (lane-major).

    ``candidate_adjust(log_probs)`` optionally rewrites each step's
    candidate scores; ``drop_callback(tokens [B, K, T], t, cand [B, K,
    V]) -> cand`` sees each lane's decoded prefix and the expanded
    candidates at step ``t`` (a Python int) and may renormalize them or
    drop nodes by writing -1e30 (the reference's NormOrDropNodeCallback);
    a finished lane's eos continuation is never dropped.

    ``trace`` (a list, optional) receives one dict a step: ``src`` and
    ``tok`` [B, K] (each survivor's source lane and token), ``top`` [B,
    K] (their scores) and ``gap`` [B] (the K-th minus the (K+1)-th
    candidate, +inf where the (K+1)-th is a dead lane's), for holding two
    runs against each other step by step.

    Returns ``BeamResult`` sorted best-first per batch row (``beam.py:
    29-116``)."""
    dev = tree_leaves(init_state)[0].device
    i32 = torch.int32
    b, k = batch_size, beam_size
    lane0 = torch.arange(b, device=dev)[:, None] * k

    def gather_state(state, src_lane):
        flat = (lane0 + src_lane).reshape(-1)
        return tree_map(lambda x: x.index_select(0, flat), state)

    state = init_state
    tokens = torch.full((b, k, max_len), eos_id, dtype=i32, device=dev)
    # lane 0 live, the others dead: the first expansion is over V, not K*V
    scores = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    prev = torch.full((b * k,), bos_id, dtype=i32, device=dev)
    lengths = torch.zeros((b, k), dtype=i32, device=dev)
    eos_only = None
    for t in range(max_len):
        log_probs, new_state = step_fn(state, prev)
        if candidate_adjust is not None:
            log_probs = candidate_adjust(log_probs)
        v = log_probs.shape[-1]
        lp = log_probs.reshape(b, k, v)
        if eos_only is None:
            eos_only = torch.full((v,), _NEG, dtype=lp.dtype, device=dev)
            eos_only[eos_id] = 0.0
        # a finished lane continues with eos alone, at zero cost
        lp = torch.where(finished[..., None], eos_only, lp)
        cand = scores[..., None] + lp                       # [B, K, V]
        if drop_callback is not None:
            adjusted = drop_callback(tokens, t, cand)
            keep_eos = finished[..., None] & (
                torch.arange(v, device=dev) == eos_id)
            cand = torch.where(keep_eos, cand, adjusted)
        top, idx, nxt = _top_k(cand.reshape(b, k * v), k)
        src_lane = torch.div(idx, v, rounding_mode="floor")
        new_tok = (idx % v).to(i32)
        # reorder histories and state by the surviving lanes
        tokens = torch.gather(tokens, 1,
                              src_lane[..., None].expand(b, k, max_len))
        tokens[:, :, t] = new_tok
        was_finished = torch.gather(finished, 1, src_lane)
        lengths = torch.gather(lengths, 1, src_lane)
        is_eos = new_tok == eos_id
        finished = was_finished | is_eos
        lengths = torch.where(was_finished | is_eos, lengths, lengths + 1)
        state = gather_state(new_state, src_lane)
        prev = new_tok.reshape(-1)
        scores = top
        if trace is not None:
            gap = (top[:, -1] - nxt if nxt is not None
                   else torch.full((b,), float("inf"), device=dev))
            if nxt is not None:
                gap = torch.where(nxt <= _DEAD, float("inf"), gap)
            trace.append({"src": src_lane.to(i32), "tok": new_tok,
                          "top": top, "gap": gap})
    if length_penalty:
        norm = ((5.0 + lengths.to(scores.dtype)) / 6.0) ** length_penalty
        scores = scores / torch.clamp(norm, min=1e-6)
    order = torch.argsort(-scores, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[..., None].expand(b, k, max_len))
    return BeamResult(tokens=tokens, scores=torch.gather(scores, 1, order),
                      lengths=torch.gather(lengths, 1, order))


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
