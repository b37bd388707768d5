"""Speculative decoding: the draft trunk and its k-token rollout
(``paddle_tpu/serving/speculative.py``).

Greedy draft / verify on the slot engine.  A small trunk — the target's
first ``layers`` blocks, sharing its embedding and vocab — runs its own
k-token autoregressive rollout per slot against a private float32 slab
KV cache, and the target's one chunked step (``lm_decode_chunk_slots``
/ ``_paged`` with ``all_lanes=True``) then scores every drafted lane at
once.  The draft only changes speed: acceptance keeps exactly the
longest prefix the target itself emits greedily, so a stream equals the
non-speculating engine's whatever the draft proposes.

Bookkeeping contract with ``DecodeEngine``: rollout K/V written past the
committed stream is never counted as ingested.  The engine re-feeds
every committed token through ``rollout`` (matched drafts re-feed
identical values, a mismatch feeds the corrected token), and the chunk
step writes all lanes before attending, so a stale rollout write is
overwritten before anything reads it.

The rollout runs on the engine's device and stream, between the
target's steps: the split-KV decode kernels keep one scratch and ticket
buffer per device (``ops/kernels/decode_attention._split_operands``),
so no two of their launches may run at once on two streams.
"""

import threading

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.quant import weights as _qw
from paddle_tpu_torch.utils.error import ConfigError


def make_draft(params, layers=2, quantize=False):
    """A draft params tree derived from the target's: the same
    embedding, positional table and final norm (the tensors shared, not
    copied: the draft adds only ``layers`` blocks of weight bytes), the
    trunk cut to the first ``layers`` blocks.  ``quantize=True``
    quantizes the draft through ``quant/weights.quantize_lm`` (the
    shared embedding too: the draft then holds its own int8 copy)."""
    n = len(params["enc"])
    if not 1 <= layers <= n:
        raise ConfigError(
            f"draft layers must be in [1, {n}] (the target's enc depth), "
            f"got {layers}")
    draft = dict(params)
    draft["enc"] = list(params["enc"][:layers])
    if quantize:
        draft = _qw.quantize_lm(draft)
    return draft


class DraftTrunk:
    """The draft half of speculative decoding: a slab KV cache with the
    target engine's slot indexing and one rollout producing k greedy
    draft tokens a slot a call.

    ``rollout(tokens, positions, lengths)``: chunk-ingest each row's
    ``lengths[r]`` committed tokens starting at ``positions[r]`` (lanes
    past the length are ignored), then ``k - 1`` single-position steps,
    each feeding the draft's own argmax back in.  Returns drafts
    [num_slots, k] (row r's candidates for stream positions
    ``positions[r] + lengths[r]`` on) — or None when ``reset()`` moved
    the epoch during the call (the caller arms nothing).

    ``rollouts`` counts the calls (a host counter: each launches the
    draft's chunk step once and its Tq=1 step ``k - 1`` times).
    ``device``: None = the card (raises without one), or ``"cpu"``.
    """

    def __init__(self, params, *, k, num_slots, max_len, chunk,
                 num_heads=8, moe_top_k=2, pos_type="learned",
                 warm=False, mesh=None, device=None):
        if k < 1:
            raise ConfigError(f"speculate_k must be >= 1, got {k}")
        if chunk < 1:
            raise ConfigError(f"draft chunk must be >= 1, got {chunk}")
        if mesh is not None:
            raise ConfigError("a tensor-parallel draft (mesh) is not yet "
                              "ported to paddle_tpu_torch (ROADMAP A12)")
        self.device = _device.resolve(device)
        # .to() on a tensor already there returns it: tensors shared with
        # the target stay shared
        self.params = transformer.tree_map(lambda t: t.to(self.device),
                                           params)
        self.k = int(k)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.chunk = int(chunk)
        self.num_heads = num_heads
        self.moe_top_k = moe_top_k
        self.pos_type = pos_type
        self._warm = False
        self.rollouts = 0
        self._epoch = 0
        self._epoch_lock = threading.Lock()
        self._cache = self._new_cache()
        if warm:
            self.warmup()

    def _new_cache(self):
        return transformer.init_lm_cache(self.params, self.num_slots,
                                         self.max_len)

    def _dummy_feed(self):
        tokens = np.zeros((self.num_slots, self.chunk), np.int32)
        positions = np.zeros((self.num_slots,), np.int32)
        lengths = np.ones((self.num_slots,), np.int32)
        return tokens, positions, lengths

    def rollout(self, tokens, positions, lengths):
        with self._epoch_lock:
            epoch, cache = self._epoch, self._cache
        self.rollouts += 1
        dev = self.device
        # one dequantization a rollout (identity on a float draft): the
        # k calls below take the float tree as it is
        params = _qw.maybe_dequant(self.params)
        tokens = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)
        positions = torch.as_tensor(np.asarray(positions, np.int32),
                                    device=dev)
        lengths = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
        common = (self.num_heads, self.moe_top_k, self.pos_type)
        logits, _ = transformer.lm_decode_chunk_slots(
            params, tokens, positions, lengths, cache, *common)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        drafts = [nxt]
        # rollout writes land past the committed stream; the clamp keeps
        # the write in bounds for rows parked at the cache's edge (their
        # junk write is re-fed before anything attends to it)
        base = positions + lengths
        for i in range(self.k - 1):
            qp = torch.clamp(base + i, max=self.max_len - 1)
            logits, _ = transformer.lm_decode_step_slots(
                params, nxt, qp, cache, *common)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(nxt)
        out = torch.stack(drafts, dim=1).cpu().numpy()
        with self._epoch_lock:
            if epoch != self._epoch:
                return None      # reset() raced the rollout
        return out

    def reset(self):
        """Invalidate the draft cache: bump the epoch and swap in a
        freshly allocated slab.  The cache is written in place, so a
        rollout still in flight writes into the discarded tensors and
        returns None.  The feed bookkeeping lives in the engine, whose
        re-seat paths rebuild it."""
        with self._epoch_lock:
            self._epoch += 1
            self._cache = self._new_cache()

    def warmup(self):
        """One rollout at the live shapes (on the card this builds the
        kernels and grows the split-KV operands for the draft's shapes),
        then a reset.  Idempotent."""
        if self._warm:
            return
        self._warm = True
        out = self.rollout(*self._dummy_feed())
        assert out is not None and out.shape == (self.num_slots, self.k)
        self.reset()
