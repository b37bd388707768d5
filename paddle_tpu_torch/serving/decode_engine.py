"""Continuous-batching generation: the slot-based KV-cache decode engine
and its request front (``paddle_tpu/serving/decode_engine.py``).

* ``DecodeEngine`` — a KV cache per layer plus per-slot host state in
  numpy.  ONE static-shape step plus argmax advances every slot; tokens,
  positions, lane counts and block tables are data, so admission and
  eviction never change the step's shapes — they happen between steps,
  on the host.  The step writes the cache in place where the JAX engine
  donated it.  Two layouts:

  - ``kv_layout="slab"``: one ``[num_slots, max_len, Dkv]`` row per slot;
  - ``kv_layout="paged"``: a shared ``[kv_num_blocks, kv_block_size,
    Dkv]`` block pool plus per-slot block tables, managed on the host by
    ``serving/kv_pool.py`` (free list, refcounts, a prefix index, and
    copy-on-write forks).  Memory is committed per block as a stream
    grows, requests sharing a prompt prefix admit by reference to the
    resident blocks, and a dry pool preempts the youngest slot, whose
    request re-seats later with its stream unchanged.

  And two ways to ingest a prompt:

  - ``prefill_chunk = K > 0`` (the serving CLI default): unified chunked
    prefill — prompts ride the decode step as up-to-K-lane chunks, their
    re-derived emissions swallowed until the last chunk, whose output is
    the first real token;
  - ``prefill_chunk = 0``, the legacy ladder: prompts are padded to a
    length bucket (``prefill_buckets``) and a batch bucket
    (``prefill_batch_buckets``), run through ``lm_prefill`` (the
    ``flash_attention`` kernel), their rows written into the slot, and
    the first token emitted at admission; the step is the Tq=1 one.

* ``GenerationBatcher`` — the request front: bounded queue, per-request
  deadlines, continuous admission into free slots, streaming
  ``on_token`` callbacks, graceful drain, and batch-failure isolation (a
  failed step fails only the requests in flight; the engine resets and
  keeps serving).  On the paged layout, requests the pool cannot hold
  yet wait (``_waiting``) and preempted ones re-seat (``_preempted``).

Either layout and either ingestion stores K/V as float32 or, with
``kv_dtype="int8"``, as int8 codes with per-(position, KV head) f32
scales (``quant/kv.py``); every cache copy (admission rows, block
writes, copy-on-write forks) carries the scales with their codes.  The
params may be an int8 weight tree (``quant/weights.quantize_lm``): each
step dequantizes it inside the call.

Speculative decoding (``speculate_k > 0`` with a ``draft``, chunked
only): a draft trunk (``serving/speculative.DraftTrunk``) proposes up to
``speculate_k`` tokens a slot between steps, the one chunked step scores
them all as verify lanes (every lane projected), and the host accepts
the longest greedily matched prefix plus the target's own token at the
first mismatch, advancing the slot past the whole run at once.  A
stream is the non-speculating engine's whatever the draft proposes.

Greedy decode only (argmax inside the step).  Not ported yet (ROADMAP),
each raising ``ConfigError`` where it is an option: tensor-parallel
meshes, the host KV tier, supervised recovery, continuation replay; and
fault injection and trace spans.
"""

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.quant.kv import KV_DTYPES
from paddle_tpu_torch.quant.weights import weight_shape as _w_shape
from paddle_tpu_torch.serving.errors import (BatchExecutionError,
                                             DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.serving.kv_pool import (InsufficientBlocksError,
                                              PagedKVState,
                                              slab_equivalent_blocks)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger

DEFAULT_PREFILL_BUCKETS = (32, 64)


def _not_ported(what):
    return ConfigError(f"{what} not yet ported to paddle_tpu_torch "
                       "(ROADMAP)")


def _buckets(name, values):
    out = tuple(sorted({int(b) for b in values}))
    if not out or out[0] < 1:
        raise ConfigError(f"bad {name} {values!r}")
    return out


class DecodeEngine:
    """Slot-based continuous-batching decoder over a decoder-only LM trunk
    (``models/transformer`` params).

    params: the trunk dict (moved to ``device``); num_slots: concurrent
    requests; max_len: per-slot span — every request must satisfy
    ``len(prompt) + max_tokens <= max_len``; eos_id: default stop token.
    device: ``None`` = the card (raises without one), or ``"cpu"``.

    prefill_chunk: K, the token lanes per slot per step (the serving CLI
    default 8), or 0 for the legacy prefill ladder; prefill_chunk_budget:
    max teacher-forced lanes one step may feed across all slots (0 =
    unbounded).  prefill_buckets: the ladder's prompt-length buckets
    (prompts pad up to the nearest; the top one caps prompt length);
    prefill_batch_buckets: the batch sizes one ladder prefill pads to.

    kv_layout: ``"slab"`` or ``"paged"``.  Paged only: kv_block_size
    (positions per block); kv_num_blocks (pool size including the
    scratch block 0; 0 = the slab-equivalent ``num_slots * ceil(max_len
    / block_size) + 1``, doubled for int8 KV); prefix_cache (share
    resident prompt-prefix blocks across requests, copy-on-write on
    divergence).

    kv_dtype: ``"float32"`` or ``"int8"`` (quantized KV on either layout
    and either ingestion; the int8 kernels read the codes and scales).

    speculate_k: draft lanes a slot a verify step (0 = off; needs
    ``prefill_chunk > 0`` and a ``draft``); draft: a ``DraftTrunk``, or
    a params tree to build one from (``speculative.make_draft``).  The
    step's lane width is ``max(prefill_chunk, speculate_k + 1)``.

    Slot lifecycle: FREE -> seated (chunked: at position 0 with the
    prompt as its feed; ladder: prefilled, at position len(prompt)) ->
    one emitted token per step -> EVICTED (eos | length | error |
    shutdown | abandoned | pool_exhausted) -> FREE.
    """

    def __init__(self, params, *, num_heads=8, num_slots=8, max_len=256,
                 prefill_buckets=DEFAULT_PREFILL_BUCKETS,
                 prefill_batch_buckets=(1, 4), eos_id=None, moe_top_k=2,
                 pos_type="learned", metrics=None, name="lm", warm=True,
                 kv_layout="slab", kv_block_size=16, kv_num_blocks=0,
                 prefix_cache=True, prefill_chunk=8, prefill_chunk_budget=0,
                 kv_dtype="float32", speculate_k=0, draft=None, mesh=None,
                 kv_host_bytes=0, device=None):
        if kv_layout not in ("slab", "paged"):
            raise ConfigError(f"kv_layout={kv_layout!r} (supported: "
                              "'slab', 'paged')")
        if kv_dtype not in KV_DTYPES:
            raise ConfigError(f"kv_dtype={kv_dtype!r} (supported: "
                              f"{KV_DTYPES})")
        if mesh is not None:
            raise _not_ported("tensor-parallel decode (mesh) is")
        if kv_host_bytes:
            raise _not_ported("the host KV tier (kv_host_bytes) is")
        if params.get("dec"):
            raise ConfigError(
                "DecodeEngine serves the decoder-only LM trunk; this params "
                "tree has a seq2seq decoder stack")
        self.device = _device.resolve(device)
        self.params = transformer.tree_map(lambda t: t.to(self.device),
                                           params)
        self.num_heads = int(num_heads)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.moe_top_k = moe_top_k
        self.pos_type = pos_type
        self.name = name
        self.kv_layout = kv_layout
        self.kv_dtype = kv_dtype
        self.prefill_chunk = int(prefill_chunk or 0)
        self.prefill_chunk_budget = int(prefill_chunk_budget or 0)
        if not 0 <= self.prefill_chunk <= self.max_len:
            raise ConfigError(f"prefill_chunk={prefill_chunk} must be in "
                              f"[0, max_len={self.max_len}]")
        self.speculate_k = int(speculate_k or 0)
        if not 0 <= self.speculate_k < self.max_len:
            raise ConfigError(
                f"speculate_k={speculate_k} must be in "
                f"[0, max_len={self.max_len})")
        if self.speculate_k and not self.prefill_chunk:
            raise ConfigError(
                "speculate_k needs the unified chunked step "
                "(prefill_chunk > 0): the verify step IS the chunk "
                "step scoring draft lanes")
        if draft is not None and not self.speculate_k:
            raise ConfigError("a draft trunk without speculate_k > 0 "
                              "would never run")
        if self.speculate_k and draft is None:
            raise ConfigError(
                "speculate_k > 0 needs a draft (a DraftTrunk, or a "
                "params tree to build one from — serving/speculative."
                "make_draft derives one from the target's)")
        # the step's lane width holds a prefill chunk and a whole verify
        # span (the committed token + speculate_k draft lanes)
        self._kk = (max(self.prefill_chunk, self.speculate_k + 1)
                    if self.prefill_chunk else 0)
        self.prefill_buckets = _buckets("prefill ladder", prefill_buckets)
        self.prefill_batch_buckets = _buckets("prefill batch ladder",
                                              prefill_batch_buckets)
        if not self.prefill_chunk \
                and self.prefill_buckets[-1] >= self.max_len:
            raise ConfigError(
                f"prefill bucket top {self.prefill_buckets[-1]} leaves no "
                f"room to generate within max_len={self.max_len}")
        if self.num_slots < 1:
            raise ConfigError("num_slots must be >= 1")
        self.metrics = metrics or ServingMetrics()
        self._paged = None
        if kv_layout == "paged":
            self.block_size = int(kv_block_size)
            if self.block_size < 1:
                raise ConfigError("kv_block_size must be >= 1")
            num_blocks = (int(kv_num_blocks) if kv_num_blocks
                          else slab_equivalent_blocks(
                              self.num_slots, self.max_len, self.block_size,
                              kv_dtype))
            self._paged = PagedKVState(self.num_slots, num_blocks,
                                       self.block_size, self.max_len,
                                       prefix_cache=prefix_cache)
        self._cache = self._new_cache()
        self.prefill_batches_total = 0     # ladder lm_prefill calls
        # host-side slot state: the token(s) fed at the NEXT step ([S] on
        # the ladder, [S, K] lanes when chunked), the lanes each slot
        # feeds (chunked), and lane 0's position.  Free slots idle at
        # (token 0, position 0, 1 lane): their compute is discarded.
        if self.prefill_chunk:
            self._tokens = np.zeros((self.num_slots, self._kk), np.int32)
            self._len = np.ones((self.num_slots,), np.int32)
        else:
            self._tokens = np.zeros((self.num_slots,), np.int32)
            self._len = None
        # the draft's host bookkeeping (speculating).  Per active slot:
        # _d_pos + len(_d_feed) == _pos + 1 — every committed token (and
        # nothing else) is either in the draft cache or waits in the feed
        self._draft = None
        if self.speculate_k:
            from paddle_tpu_torch.serving.speculative import DraftTrunk
            if not isinstance(draft, DraftTrunk):
                draft = DraftTrunk(
                    draft, k=self.speculate_k, num_slots=self.num_slots,
                    max_len=self.max_len,
                    chunk=max(self.speculate_k + 2, self.prefill_chunk),
                    num_heads=self.num_heads, moe_top_k=self.moe_top_k,
                    pos_type=self.pos_type, device=self.device)
            elif (draft.k != self.speculate_k
                  or draft.num_slots != self.num_slots
                  or draft.max_len < self.max_len
                  or draft.device != self.device):
                raise ConfigError(
                    f"draft trunk (k={draft.k}, slots={draft.num_slots}, "
                    f"max_len={draft.max_len}, {draft.device}) does not "
                    f"match the engine (k={self.speculate_k}, "
                    f"slots={self.num_slots}, max_len={self.max_len}, "
                    f"{self.device})")
            self._draft = draft
            self._d_feed = [[] for _ in range(self.num_slots)]
            self._d_pos = np.zeros((self.num_slots,), np.int32)
            self._d_last = np.zeros((self.num_slots,), np.int32)
            self._spec_armed = {}     # slot -> k_eff armed for the next step
            self._spec_result = {}    # slot -> the last step's accepted run
        self._pos = np.zeros((self.num_slots,), np.int32)
        self._free = list(range(self.num_slots))[::-1]   # pop() -> slot 0
        self._warm = False
        if warm:
            self.warmup()

    def _new_cache(self):
        """A zeroed slab, or a zeroed pool with the pool gauges set (a
        learned positional table caps max_len either way)."""
        if self._paged is None:
            return transformer.init_lm_cache(
                self.params, self.num_slots, self.max_len,
                kv_dtype=self.kv_dtype, num_heads=self.num_heads)
        pool = self._paged.pool
        self.metrics.set_kv_pool(pool.num_free, pool.num_allocatable)
        return transformer.init_lm_cache_paged(
            self.params, pool.num_blocks, self.block_size,
            max_len=self.max_len, kv_dtype=self.kv_dtype,
            num_heads=self.num_heads)

    # ------------------------------------------------------------ slots

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, m):
        # the config gauges travel with a swapped-in metrics object
        self._metrics = m
        m.set_prefill_chunk(self.prefill_chunk)
        m.set_kv_dtype(self.kv_dtype)
        m.set_speculate_k(self.speculate_k)

    @property
    def chunked(self):
        """True when prompts ride the unified chunked step, False on the
        legacy prefill ladder."""
        return self.prefill_chunk > 0

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def num_active(self):
        return self.num_slots - len(self._free)

    @property
    def ready(self):
        return self._warm

    def _arm(self, slot, token, pos):
        """Point a slot at (token, position) for the next step — the one
        place the two token layouts ([S] and [S, K]) meet."""
        if self.prefill_chunk:
            self._tokens[slot, :] = 0
            self._tokens[slot, 0] = token
            self._len[slot] = 1
        else:
            self._tokens[slot] = token
        self._pos[slot] = pos

    def seat_chunked(self, full):
        """Seat one request for chunked ingestion: arm a free slot at
        (``full[0]``, position 0) and return ``(slot, feed)`` where
        ``feed = full[1:]`` is what the batcher chunk-loads through the
        step.  The slab touches no device state; the paged layout seats
        an EMPTY chain that ``prepare_step`` grows block by block."""
        if not self._free:
            raise RuntimeError(f"{self.name}: no free decode slot")
        full = np.asarray(full, np.int32)
        slot = self._free.pop()
        if self._paged is not None:
            try:
                self._paged.seat_fresh(slot, 0)
            except InsufficientBlocksError:
                self._free.append(slot)
                raise
        self._arm(slot, full[0], 0)
        self._draft_seed(slot, full[:1])
        return slot, [int(t) for t in full[1:]]

    def seat_cached(self, full, covered, chain):
        """Seat a request whose leading ``covered`` positions are RESIDENT
        in ``chain`` (a prefix-cache hit, paged only): take shared
        references — no prefill, no copy — arm the slot at ``pre =
        min(covered, len(full) - 1)`` with ``full[pre]``, and return
        ``(slot, feed)``, feed = ``full[pre+1:]`` teacher-forced with its
        emissions swallowed.  A first write inside the last shared block
        is forked by ``prepare_step`` before the step touches it."""
        if not self._free:
            raise RuntimeError(f"{self.name}: no free decode slot")
        full = np.asarray(full, np.int32)
        pre = min(int(covered), full.size - 1)
        slot = self._free.pop()
        try:
            self._paged.seat_shared(slot, chain, pre + 1)
        except Exception:
            self._free.append(slot)
            raise
        self._arm(slot, full[pre], pre)
        # the draft cache holds nothing for this slot (the prefix index
        # is the target's): the covered prefix joins the draft's feed
        self._draft_seed(slot, full[:pre + 1])
        return slot, [int(t) for t in full[pre + 1:]]

    def load_chunk(self, slot, toks):
        """Arm lanes 1..n of ``slot`` for the NEXT step (the next
        teacher-forced tokens after the slot's current token)."""
        n = len(toks)
        if not self.prefill_chunk or n >= self.prefill_chunk:
            raise RuntimeError(f"{self.name}: load_chunk({n}) needs "
                               f"prefill_chunk > {n} (engine has "
                               f"{self.prefill_chunk})")
        self._tokens[slot, 1:1 + n] = toks
        self._len[slot] = 1 + n
        self.metrics.observe_prefill_chunk(n)

    def chunk_len(self, slot):
        """Lanes the next/current step feeds for ``slot`` (1 = decode)."""
        return int(self._len[slot]) if self.prefill_chunk else 1

    # ------------------------------------------------------------ speculation

    @property
    def speculating(self):
        """True when a draft trunk is attached (``speculate_k > 0``)."""
        return self._draft is not None

    @property
    def draft(self):
        """The attached ``DraftTrunk`` (None unless speculating)."""
        return self._draft

    def _draft_seed(self, slot, toks):
        """(Re)start a slot's draft bookkeeping: the draft cache holds
        nothing for it yet, so ``toks`` (its committed context so far)
        becomes the feed the next ``speculate`` calls drain through the
        draft's chunk ingest.  Called at every seat and eviction."""
        if self._draft is None:
            return
        self._d_feed[slot] = [int(t) for t in toks]
        self._d_pos[slot] = 0
        self._d_last[slot] = 0
        self._spec_armed.pop(slot, None)
        self._spec_result.pop(slot, None)

    def speculate(self, budgets):
        """One batched draft rollout, between steps: drain up to a chunk
        of every active slot's committed-token feed into the draft
        cache, then arm draft lanes for each slot in ``budgets`` (slot ->
        remaining emission allowance) whose feed drained fully in this
        call (the rollout's candidates are fresh only for those).  Lanes
        1..k_eff of the verify span take the drafts (lane 0 stays the
        committed token), ``k_eff = min(speculate_k, budget - 1, room to
        max_len)``.  Returns {slot: k_eff}.  The drafts' copy to the host
        is this call's one synchronization."""
        if self._draft is None:
            return {}
        chunk = self._draft.chunk
        tokens = np.zeros((self.num_slots, chunk), np.int32)
        positions = np.zeros((self.num_slots,), np.int32)
        lengths = np.ones((self.num_slots,), np.int32)
        fed = {}
        free_set = set(self._free)
        for slot in range(self.num_slots):
            if slot in free_set:
                continue
            feed = self._d_feed[slot]
            take = min(chunk, len(feed))
            if take:
                tokens[slot, :take] = feed[:take]
                positions[slot] = self._d_pos[slot]
                lengths[slot] = take
                fed[slot] = take
            else:
                # nothing pending: re-feed the last ingested token (an
                # identical K/V rewrite) rather than leave the row out
                tokens[slot, 0] = self._d_last[slot]
                positions[slot] = max(int(self._d_pos[slot]) - 1, 0)
        drafts = self._draft.rollout(tokens, positions, lengths)
        if drafts is None:
            return {}       # reset() raced the rollout: arm nothing
        for slot, take in fed.items():
            self._d_last[slot] = self._d_feed[slot][take - 1]
            del self._d_feed[slot][:take]
            self._d_pos[slot] += take
        armed = {}
        for slot, budget in budgets.items():
            if fed.get(slot) is None or self._d_feed[slot]:
                continue    # feed not fully drained: candidates stale
            k_eff = min(self.speculate_k, int(budget) - 1,
                        self.max_len - 1 - int(self._pos[slot]))
            if k_eff < 1:
                continue
            self._tokens[slot, 1:1 + k_eff] = drafts[slot, :k_eff]
            self._tokens[slot, 1 + k_eff:] = 0
            self._len[slot] = 1 + k_eff
            self._spec_armed[slot] = k_eff
            armed[slot] = k_eff
        return armed

    def take_spec_result(self, slot):
        """Pop the last step's accepted run for ``slot``: the matched
        draft tokens followed by the target's own argmax at the first
        mismatch (never empty: a verify step nets at least the token a
        plain step would).  None if the slot did not speculate."""
        if self._draft is None:
            return None
        return self._spec_result.pop(slot, None)

    def register_context(self, slot, tokens):
        """Publish a fully ingested prompt's prefixes into the paged
        prefix index (no-op on the slab or with the cache off)."""
        if self._paged is not None:
            self._paged.register_prefix(np.asarray(tokens, np.int32), slot)

    def evict(self, slot, reason):
        """Free a slot between steps.  Slab: the row is left as-is (the
        next occupant rewrites each position before unmasking it).
        Paged: the slot's block references release (shared blocks stay
        for their other sharers / the prefix index)."""
        if self._paged is not None:
            self._paged.evict(slot)
        self._arm(slot, 0, 0)
        self._draft_seed(slot, [])
        self._free.append(slot)
        self.metrics.evict_slot(reason)

    # ------------------------------------------------------------ ladder

    def prefill_bucket_for(self, n):
        """Smallest prompt-length bucket >= n, or None beyond the top."""
        for b in self.prefill_buckets:
            if b >= n:
                return b
        return None

    def _batch_bucket(self, n):
        for b in self.prefill_batch_buckets:
            if b >= n:
                return b
        return self.prefill_batch_buckets[-1]

    def _prefill_batch(self, prompts, lengths):
        """One ``lm_prefill`` over padded prompts [B, bucket] (the
        ``flash_attention`` kernel runs there): (first tokens [B] on the
        host, the bucket-length cache [B, bucket, Dkv] per layer).  Each
        row's first token comes from its last real position's hidden
        state, gathered before the d_model x vocab projection as
        ``lm_generate`` does."""
        dev = self.device
        hidden, cache = transformer.lm_prefill(
            self.params, torch.from_numpy(prompts).to(dev), prompts.shape[1],
            self.num_heads, self.moe_top_k, self.pos_type,
            kv_dtype=self.kv_dtype)
        last = torch.from_numpy(lengths - 1).to(dev).long()
        h_last = hidden[torch.arange(len(lengths), device=dev), last]
        logits = transformer._lm_project(self.params, h_last)
        return torch.argmax(logits, -1).to(torch.int32).cpu().numpy(), cache

    def prefill(self, prompts, lengths):
        """Run prompts through the length-bucketed ladder.  prompts
        [n, L] int32 (rows padded to a common L <= the ladder top; the
        pad value is irrelevant), lengths [n] real lengths.  Rows pad to
        the length bucket and, in groups of at most the top batch bucket,
        to a batch bucket.  Returns (first tokens [n], per-row cache rows:
        a list of n per-layer ``{"k", "v"}`` of [bucket, Dkv] on the
        device, with ``{"ks", "vs"}`` of [bucket, Hkv] on an int8 cache —
        what ``admit`` writes)."""
        prompts = np.asarray(prompts, np.int32)
        lengths = np.asarray(lengths, np.int32)
        n, t = prompts.shape
        bucket = self.prefill_bucket_for(t)
        if bucket is None:
            raise InvalidRequestError(
                f"prompt length {t} exceeds the prefill ladder top "
                f"{self.prefill_buckets[-1]}")
        top = self.prefill_batch_buckets[-1]
        firsts, rows = [], []
        for i0 in range(0, n, top):
            m = min(top, n - i0)
            nb = self._batch_bucket(m)
            padded = np.zeros((nb, bucket), np.int32)
            padded[:m, :t] = prompts[i0:i0 + m]
            lens = np.ones((nb,), np.int32)
            lens[:m] = lengths[i0:i0 + m]
            first, cache = self._prefill_batch(padded, lens)
            self.prefill_batches_total += 1
            firsts.append(first[:m])
            rows += [[{key: buf[i] for key, buf in c.items()}
                      for c in cache] for i in range(m)]
        return np.concatenate(firsts), rows

    def admit(self, first_token, cache_row, length, tokens=None):
        """Seat one prefilled request and arm a free slot at
        (first_token, position=length); returns the slot.

        Slab: write the bucket-length rows into positions [0, bucket) of
        the slot's row (the tail keeps the previous occupant's values,
        each rewritten by the step in the same step that first unmasks
        it).  Paged: claim ``ceil(length / block_size)`` private blocks
        and write the rows into them block by block (zero-padded past the
        bucket), then, given ``tokens`` (the real prefix ids), publish
        the prefixes to the index.  Raises ``InsufficientBlocksError``
        (nothing claimed) when the pool is dry."""
        if not self._free:
            raise RuntimeError(f"{self.name}: no free decode slot")
        slot = self._free.pop()
        if self._paged is not None:
            try:
                chain = self._paged.seat_fresh(slot, int(length))
            except InsufficientBlocksError:
                self._free.append(slot)
                raise
            self._write_blocks(chain, cache_row)
            if tokens is not None:
                self._paged.register_prefix(
                    np.asarray(tokens)[:int(length)], slot)
        else:
            for c, row in zip(self._cache, cache_row):
                for key, src in row.items():
                    c[key][slot, :src.shape[0]].copy_(src)
        self._arm(slot, first_token, length)
        return slot

    def _write_blocks(self, chain, cache_row):
        """Blocks ``chain`` of every layer's pool (and scale pool) <- the
        row's positions [0, len(chain) * block_size), zero-padded past the
        row."""
        if not chain:
            return
        bs, nb = self.block_size, len(chain)
        idx = torch.tensor(chain, dtype=torch.long, device=self.device)
        for c, row in zip(self._cache, cache_row):
            for key, full in row.items():
                src = full[:nb * bs]
                chunk = src.new_zeros((nb * bs, src.shape[-1]))
                chunk[:src.shape[0]] = src
                c[key].index_copy_(0, idx, chunk.view(nb, bs, -1))

    # ------------------------------------------------------------ seating

    def seat_prefilled(self, fulls):
        """THE seat-prefix helper (paged prefix-cache admission, pool-
        pressure re-seating and every chunked admission): for each 1-D
        ``full`` context, seat a slot holding K/V for its prefix with the
        following token armed, WITHOUT re-emitting anything:

        1. paged + prefix cache: a resident chain seats by REFERENCE
           (``seat_cached``);
        2. otherwise chunked: ``seat_chunked`` with the whole context as
           the feed; on the ladder: re-prefill the longest ladder-covered
           prefix ``full[:min(len(full) - 1, top)]`` (same-bucket items
           as one batch) and ``admit`` it.

        The remainder returns as the teacher-forced feed, its re-derived
        emissions swallowed by the batcher; greedy decode being
        deterministic, the slot ends at its target state.  Returns a list
        aligned with ``fulls``: ``(slot, feed)`` per seated item, or the
        exception that failed it (``InsufficientBlocksError`` means
        "defer and retry", not "fail")."""
        results = [None] * len(fulls)
        prep = []
        for i, full in enumerate(fulls):
            full = np.asarray(full, np.int32)
            pre = (full.size if self.prefill_chunk
                   else min(full.size - 1, self.prefill_buckets[-1]))
            if self._paged is not None:
                covered, chain = self._paged.lookup_prefix(full)
                if covered and self.cached_seat_worthwhile(covered,
                                                           full.size):
                    try:
                        results[i] = self.seat_cached(full, covered, chain)
                    except Exception as e:    # noqa: BLE001 — isolate
                        results[i] = e        # to this item
                    continue
                # pool-dry fast path: defer before burning any work
                if not self.can_admit(pre + 1):
                    results[i] = InsufficientBlocksError(
                        f"pool cannot hold {pre + 1} positions yet")
                    continue
            if self.prefill_chunk:
                try:
                    results[i] = self.seat_chunked(full)
                except Exception as e:    # noqa: BLE001 — per-item
                    results[i] = e
                continue
            prep.append((i, full, pre))
        groups = {}
        for item in prep:
            groups.setdefault(self.prefill_bucket_for(item[2]),
                              []).append(item)
        for bucket, items in sorted(groups.items()):
            prompts = np.zeros((len(items), bucket), np.int32)
            lengths = np.zeros((len(items),), np.int32)
            for j, (_i, full, pre) in enumerate(items):
                prompts[j, :pre] = full[:pre]
                lengths[j] = pre
            try:
                _first, rows = self.prefill(prompts, lengths)
            except Exception as e:      # noqa: BLE001 — crosses to the
                for i, _full, _pre in items:    # caller per item
                    results[i] = e
                continue
            for j, (i, full, pre) in enumerate(items):
                try:
                    # arm with the recorded stream's next token
                    slot = self.admit(full[pre], rows[j], pre,
                                      tokens=full[:pre])
                except Exception as e:  # noqa: BLE001
                    results[i] = e
                    continue
                results[i] = (slot, [int(t) for t in full[pre + 1:]])
        return results

    def cached_seat_worthwhile(self, covered, size):
        """Seat through the prefix cache only when it pays.  Chunked: any
        coverage shrinks the feed.  Ladder: the uncovered remainder
        teacher-forces ONE STEP PER TOKEN, so coverage must save at least
        half the ladder-covered prefill, or the request seats faster as
        an ordinary miss."""
        if self.prefill_chunk:
            return covered > 0
        return covered * 2 >= min(int(size) - 1, self.prefill_buckets[-1])

    def prefix_lookup(self, prompt):
        """``(covered_positions, chain)`` of the longest cached prefix of
        ``prompt`` — ``(0, [])`` on a miss or on the slab.  Read-only (an
        LRU touch); seating takes the references."""
        if self._paged is None:
            return 0, []
        return self._paged.lookup_prefix(np.asarray(prompt))

    def can_admit(self, n_positions):
        """Paged admission gate: could the pool produce blocks covering
        ``n_positions`` now (free list + evictable prefix entries)?
        Always True on the slab."""
        if self._paged is None:
            return True
        return self._paged.can_admit(int(n_positions))

    def kv_blocks_free(self):
        """Free blocks in the paged pool (None on the slab)."""
        return None if self._paged is None else self._paged.pool.num_free

    def kv_blocks_for(self, n_positions):
        return self._paged.blocks_for(n_positions)

    # ------------------------------------------------------------ stepping

    def prepare_step(self):
        """Paged: make every active slot's write positions of the next
        step exclusive — grow chains into fresh blocks and copy-on-write
        fork blocks still shared (``cow_forks_total``); the fork is a
        block copy on the step's stream, before the step.  Under pool
        exhaustion, preempt victim slots youngest first
        (``evictions{reason="pool_exhausted"}``) and return their ids —
        the batcher re-seats those requests later, their streams
        unchanged.  Slab: no-op."""
        if self._paged is None:
            return []
        victims = []
        free_set = set(self._free)
        bs = self.block_size
        for slot in range(self.num_slots):
            if slot in free_set or slot in victims:
                continue
            pos = int(self._pos[slot])
            # a chunked step writes a SPAN (lanes 0 .. _len-1): provision
            # every touched block in order, each fork copied at once so a
            # mid-span exhaustion never orphans a planned fork
            n = int(self._len[slot]) if self.prefill_chunk else 1
            for j in range(pos // bs, (pos + n - 1) // bs + 1):
                p = pos if j == pos // bs else j * bs
                while True:
                    try:
                        plan = self._paged.write_plan(slot, p)
                    except InsufficientBlocksError:
                        v = self._paged.victim(
                            exclude=set(victims) | {slot})
                        if v is None:
                            raise     # one request outgrew the pool:
                            #           validate_request bounds this
                        self.evict(v, "pool_exhausted")
                        victims.append(v)
                        continue
                    break
                if plan is not None and plan[0] == "cow":
                    _tag, _j, src, dst = plan
                    # every leaf: an int8 block's scales fork with it
                    for c in self._cache:
                        for buf in c.values():
                            buf[dst].copy_(buf[src])
                    self.metrics.observe_cow_fork()
        return victims

    def _run(self, tokens, pos, lens):
        """The step on the device: next token per slot as a host array
        (lens is None on the ladder); speculating, every lane's argmax
        [S, K].  The one host synchronization is the argmax result's
        copy."""
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        tables = (put(self._paged.tables.copy()) if self._paged is not None
                  else None)
        common = (self.num_heads, self.moe_top_k, self.pos_type)
        spec = self._draft is not None
        if self.prefill_chunk and tables is not None:
            logits, self._cache = transformer.lm_decode_chunk_paged(
                self.params, put(tokens), put(pos), put(lens), self._cache,
                tables, *common, all_lanes=spec)
        elif self.prefill_chunk:
            logits, self._cache = transformer.lm_decode_chunk_slots(
                self.params, put(tokens), put(pos), put(lens), self._cache,
                *common, all_lanes=spec)
        elif tables is not None:
            logits, self._cache = transformer.lm_decode_step_paged(
                self.params, put(tokens), put(pos), self._cache, tables,
                *common)
        else:
            logits, self._cache = transformer.lm_decode_step_slots(
                self.params, put(tokens), put(pos), self._cache, *common)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def step(self):
        """Advance EVERY slot (free slots compute too — fixed shape);
        returns the next token per slot ([num_slots] np.int32).  Callers
        then bump their active slots via ``advance``; a speculating
        slot's accepted run waits in ``take_spec_result``."""
        tokens, pos = self._tokens.copy(), self._pos.copy()
        lens = self._len.copy() if self.prefill_chunk else None
        spec_armed = {}
        if self._draft is not None:
            spec_armed, self._spec_armed = self._spec_armed, {}
        t0 = time.perf_counter()
        nxt = self._run(tokens, pos, lens)
        chunk_lanes = (int(lens.sum() - self.num_slots)
                       if lens is not None else 0)
        kw = {}
        if self._draft is not None:
            # row[i] is the target's greedy pick after lane i.  Lanes
            # 1..k_eff held drafts d_1..d_k; the matched prefix is the
            # run of d_{i+1} == row[i], and row[j] at the first mismatch
            # is the target's own next token, so the run row[:j + 1] is
            # what sequential greedy decode emits.  A row that did not
            # speculate reduces to its last fed lane
            rows = nxt
            nxt = rows[np.arange(self.num_slots), lens - 1]
            accepted = drafted = 0
            for slot, k_eff in spec_armed.items():
                row, want = rows[slot], tokens[slot, 1:1 + k_eff]
                j = 0
                while j < k_eff and int(row[j]) == int(want[j]):
                    j += 1
                self._spec_result[slot] = [int(t) for t in row[:j + 1]]
                accepted += j
                drafted += k_eff
            # draft lanes are speculation, not prompt ingestion
            chunk_lanes -= drafted
            kw = dict(accepted_tokens=accepted, drafted_tokens=drafted,
                      spec_slots=len(spec_armed))
        self.metrics.observe_decode_step(
            self.num_active, self.num_slots, time.perf_counter() - t0,
            prefill_lanes=chunk_lanes, **kw)
        if self._paged is not None:
            self.metrics.set_kv_pool(self._paged.pool.num_free,
                                     self._paged.pool.num_allocatable)
        return nxt

    def advance(self, slot, token, consumed=1):
        """Record the token fed at the next step for ``slot``, advanced
        past the ``consumed`` lanes the last step processed.
        Speculating, the committed tokens join the draft's feed and, on
        the paged layout, the blocks the verify span provisioned past
        the committed stream go back to the pool."""
        if self._draft is not None:
            # lanes 1..consumed-1 are read before lane 0 is overwritten
            self._d_feed[slot].extend(
                [int(t) for t in self._tokens[slot, 1:consumed]]
                + [int(token)])
        if self.prefill_chunk:
            self._tokens[slot, 0] = token
            self._len[slot] = 1
        else:
            self._tokens[slot] = token
        self._pos[slot] += consumed
        if self._draft is not None and self._paged is not None:
            # keep the block the next write lands in
            self._paged.truncate(slot, int(self._pos[slot]) + 1)

    def reset(self):
        """Drop all slot state and re-zero the cache (the batch-failure
        isolation path: a failed step must not leak a poisoned cache into
        the next batch).  Paged: a fresh allocator and an empty prefix
        index, since every cached chain died with the old pool."""
        if self._paged is not None:
            old = self._paged
            self._paged = PagedKVState(
                self.num_slots, old.pool.num_blocks, self.block_size,
                self.max_len, prefix_cache=old.index is not None)
        self._cache = self._new_cache()
        self._tokens[:] = 0
        self._pos[:] = 0
        if self.prefill_chunk:
            self._len[:] = 1
        self._free = list(range(self.num_slots))[::-1]
        if self._draft is not None:
            # both caches rebuild; re-seats re-feed the draft
            self._draft.reset()
            self._d_feed = [[] for _ in range(self.num_slots)]
            self._d_pos[:] = 0
            self._d_last[:] = 0
            self._spec_armed.clear()
            self._spec_result.clear()

    def warmup(self):
        """Run the step once on the idle cache (and, on the ladder, one
        prefill) before traffic: on the card this builds and loads the
        kernels, so the first request does not pay for ``nvcc``.  No
        metrics are recorded."""
        if self._warm:
            return
        if self._draft is not None:
            self._draft.warmup()
        if not self.prefill_chunk:
            b = self.prefill_batch_buckets[0]
            self._prefill_batch(
                np.zeros((b, self.prefill_buckets[0]), np.int32),
                np.ones((b,), np.int32))
        self._run(self._tokens, self._pos, self._len)
        self._warm = True
        logger.info("decode[%s]: warm on %s (%d slots, max_len %d, kv %s "
                    "%s, %s)", self.name, self.device, self.num_slots,
                    self.max_len, self.kv_layout, self.kv_dtype,
                    (f"chunk K={self.prefill_chunk}, speculate_k="
                     f"{self.speculate_k}") if self.prefill_chunk
                    else f"prefill ladder {list(self.prefill_buckets)}")

    # ------------------------------------------------------------ validate

    def validate_request(self, prompt, max_tokens):
        """Admission checks, raised BEFORE the queue: a non-empty 1-D
        in-vocab id sequence (at most the ladder top on the ladder), an
        int max_tokens >= 1, ``len(prompt) + max_tokens <= max_len``, and
        on the paged layout a request that fits the pool alone."""
        ids = np.asarray(prompt)
        if ids.ndim != 1 or ids.size < 1:
            raise InvalidRequestError(
                f"prompt must be a non-empty 1-D id sequence, got shape "
                f"{ids.shape}")
        if not np.issubdtype(ids.dtype, np.integer):
            raise InvalidRequestError(
                f"prompt must be integer token ids, got {ids.dtype}")
        vocab = _w_shape(self.params["src_emb"])[0]
        if int(ids.min()) < 0 or int(ids.max()) >= vocab:
            raise InvalidRequestError(
                f"prompt ids must be in [0, {vocab}); got "
                f"[{int(ids.min())}, {int(ids.max())}]")
        if not self.prefill_chunk and ids.size > self.prefill_buckets[-1]:
            raise InvalidRequestError(
                f"prompt length {ids.size} exceeds the prefill ladder top "
                f"{self.prefill_buckets[-1]}")
        try:
            max_tokens = int(max_tokens)
        except (TypeError, ValueError):
            raise InvalidRequestError(
                f"max_tokens must be an int, got {max_tokens!r}") from None
        if max_tokens < 1:
            raise InvalidRequestError(f"max_tokens={max_tokens} must be "
                                      ">= 1")
        if ids.size + max_tokens > self.max_len:
            raise InvalidRequestError(
                f"prompt ({ids.size}) + max_tokens ({max_tokens}) exceeds "
                f"the engine max_len ({self.max_len})")
        self._check_pool_fit(ids.size + max_tokens)
        return ids.astype(np.int32), max_tokens

    def _check_pool_fit(self, n_positions):
        """Paged: one request must fit the pool ALONE (preemption can
        evict every other slot but never this one)."""
        if self._paged is None:
            return
        need = self._paged.blocks_for(n_positions)
        if need > self._paged.pool.num_allocatable:
            raise InvalidRequestError(
                f"request needs {need} KV blocks of {self.block_size} "
                f"positions but the pool only holds "
                f"{self._paged.pool.num_allocatable}")


class _GenRequest:
    __slots__ = ("prompt", "max_tokens", "eos_id", "future", "deadline",
                 "t_submit", "t_first", "on_token", "tokens", "slot",
                 "abandoned", "feed", "started", "admit_covered",
                 "prefix_counted")

    def __init__(self, prompt, max_tokens, eos_id, deadline, on_token):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.future = Future()
        self.deadline = deadline          # absolute perf_counter() or None
        self.t_submit = time.perf_counter()
        self.t_first = None
        self.on_token = on_token
        self.tokens = []
        self.slot = None
        self.abandoned = False
        self.feed = []                    # context tokens still to ingest
        self.started = False              # future marked running (a pool-
        #                                   deferred request re-enters
        #                                   admission; it fires once)
        self.admit_covered = 0            # this admission pass's prefix-
        #                                   cache coverage
        self.prefix_counted = False       # prefix hit/miss observed once

    def fail(self, exc):
        try:
            self.future.set_exception(exc)
        except InvalidStateError:
            pass

    def emit(self, token, name):
        self.tokens.append(int(token))
        if self.t_first is None:
            self.t_first = time.perf_counter()
        if self.on_token is not None:
            try:
                self.on_token(int(token))
            except Exception as e:    # noqa: BLE001 — a client callback
                # must never wedge the decode loop
                logger.warning("%s: on_token callback failed: %s: %s",
                               name, type(e).__name__, e)
                self.on_token = None


class GenerationBatcher:
    """Continuous-batching front for a ``DecodeEngine``.

    ONE worker thread runs the loop: seat queued requests into free slots
    (on the ladder, prefilling same-bucket prompts together and emitting
    their first token), arm each ingesting slot's next prompt chunk,
    run the draft's rollout and arm verify lanes (speculating), provision
    the paged blocks (``prepare_step``), run one step, deliver each
    emitting slot's token (a speculating slot's accepted run), evict
    finished slots.  Admission happens
    strictly between steps, so the step never changes shape.  The worker
    issues all device work.  ``supervisor`` must be None: supervised
    recovery is not ported yet (ROADMAP)."""

    def __init__(self, engine, queue_size=256, default_deadline_ms=None,
                 default_max_tokens=64, name=None, supervisor=None):
        if supervisor is not None:
            raise _not_ported("supervised recovery (supervisor) is")
        if int(queue_size) < 1:
            raise ValueError("queue_size must be >= 1")
        self.engine = engine
        self.metrics = engine.metrics
        self.default_deadline_s = (float(default_deadline_ms) / 1e3
                                   if default_deadline_ms else None)
        self.default_max_tokens = int(default_max_tokens)
        self._q = queue.Queue(maxsize=int(queue_size))
        self._depth_fn = self._q.qsize
        self.metrics.queue_depth_fns.append(self._depth_fn)
        self._closed = threading.Event()
        self._drain = True
        self._admit_lock = threading.Lock()
        self._by_slot = {}          # slot -> _GenRequest
        self._abandoned = set()     # futures abandoned while running but
        #                             not seated (deferred, preempted)
        # paged-layout overflow lanes (worker-thread only): _waiting holds
        # popped requests the pool cannot seat yet (retried ahead of the
        # queue); _preempted holds requests whose slot was evicted under
        # pool pressure — they re-seat from prompt + delivered tokens
        self._waiting = collections.deque()
        self._preempted = []
        # speculating: tokens delivered by a verify run -> number of runs
        self.verify_runs = collections.Counter()
        self.name = name or f"gen_batcher[{engine.name}]"
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    # ------------------------------------------------------------ submit

    def submit(self, prompt, max_tokens=None, eos_id=None, deadline_ms=None,
               on_token=None):
        """Admit one generation request; returns a Future resolving to
        ``{"tokens": [ids...], "finish_reason": "eos"|"length"|
        "abandoned", "ttft_ms": float}``.  ``on_token`` is called per
        emitted token from the worker thread (exceptions are logged,
        never fatal).  Raises synchronously: ``InvalidRequestError``,
        ``OverloadedError`` (queue full), ``ShutdownError`` (draining)."""
        if self._closed.is_set():
            self.metrics.reject("shutdown")
            raise ShutdownError(f"{self.name} is draining; submit rejected")
        try:
            prompt, max_tokens = self.engine.validate_request(
                prompt, max_tokens if max_tokens is not None
                else self.default_max_tokens)
        except InvalidRequestError:
            self.metrics.reject("invalid")
            raise
        dl_s = (float(deadline_ms) / 1e3 if deadline_ms
                else self.default_deadline_s)
        req = _GenRequest(prompt, max_tokens,
                          self.engine.eos_id if eos_id is None else eos_id,
                          time.perf_counter() + dl_s if dl_s else None,
                          on_token)
        with self._admit_lock:
            if self._closed.is_set():     # close() raced the check above
                self.metrics.reject("shutdown")
                raise ShutdownError(
                    f"{self.name} is draining; submit rejected")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self.metrics.reject("overload")
                raise OverloadedError(
                    f"{self.name}: queue full ({self._q.maxsize} waiting)") \
                    from None
        self.metrics.accepted()
        return req.future

    def generate(self, prompt, timeout=None, **kw):
        """submit() + block for the result."""
        return self.submit(prompt, **kw).result(timeout)

    def abandon(self, future):
        """The caller behind ``future`` is gone: a still-queued request is
        cancelled outright; a seated one is flagged and evicted at the
        next token boundary; one running but not seated (deferred,
        preempted, mid-prefill) is flagged for admission to drop."""
        if future.done() or future.cancel():
            return
        for req in list(self._by_slot.values()):
            if req.future is future:
                req.abandoned = True
                return
        self._abandoned.add(future)

    # ------------------------------------------------------------ worker

    def _pull(self, block):
        if self._waiting:               # pool-deferred requests go first
            return self._waiting.popleft()
        try:
            return (self._q.get(timeout=0.05) if block
                    else self._q.get_nowait())
        except queue.Empty:
            return None

    def _resolve(self, req, reason):
        self._abandoned.discard(req.future)
        ttft = (req.t_first - req.t_submit) if req.t_first else 0.0
        self.metrics.observe_response(time.perf_counter() - req.t_submit)
        try:
            req.future.set_result({"tokens": list(req.tokens),
                                   "finish_reason": reason,
                                   "ttft_ms": round(ttft * 1e3, 3)})
        except InvalidStateError:
            pass

    def _finish(self, req, reason):
        """Evict a seated request and resolve its future."""
        self.engine.evict(req.slot, reason)
        del self._by_slot[req.slot]
        req.slot = None
        self._resolve(req, reason)

    def _flag_abandoned(self, req):
        """Fold an ``abandon()`` made while unseated into the flag."""
        if req.future in self._abandoned:
            self._abandoned.discard(req.future)
            req.abandoned = True
        return req.abandoned

    def _admit_from_queue(self, block):
        """Fill free slots from the queue (strictly between steps).
        Expired or cancelled requests never take a slot.

        Chunked: every request seats through ``engine.seat_prefilled``
        and its prompt drains through the step as chunks.  Ladder: fresh
        prompts prefill WHOLE in same-bucket groups and their first token
        is delivered at admission; paged prefix-cache hits seat through
        ``seat_prefilled`` instead.  On the paged layout, requests the
        pool cannot hold yet are DEFERRED (``_waiting``), never failed."""
        self._reseat_preempted()
        block = block and not self._preempted
        picked, stashed = [], []
        kv_budget = self.engine.kv_blocks_free()
        while self.engine.free_slots > len(picked):
            req = self._pull(block and not picked)
            if req is None:
                break
            block = False
            now = time.perf_counter()
            if req.deadline is not None and now > req.deadline:
                self.metrics.reject("deadline")
                req.fail(DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{(now - req.t_submit) * 1e3:.1f}ms in queue"))
                continue
            if not req.started:
                if not req.future.set_running_or_notify_cancel():
                    continue        # client cancelled while queued
                req.started = True
            covered = 0
            if kv_budget is not None:
                covered = self.engine.prefix_lookup(req.prompt)[0]
                if not self.engine.cached_seat_worthwhile(
                        covered, req.prompt.size):
                    covered = 0    # route (and budget) it as a miss
                if not covered:
                    # a miss claims blocks for its whole prompt: defer it
                    # while the pool (less what this round already
                    # earmarked) cannot hold them
                    need = self.engine.kv_blocks_for(req.prompt.size + 1)
                    if need > kv_budget and not self.engine.can_admit(
                            req.prompt.size + 1):
                        stashed.append(req)
                        continue
                    kv_budget -= need
            req.admit_covered = covered
            picked.append(req)
        self._waiting.extend(stashed)
        if not picked:
            return
        fresh, recon = [], []
        for req in picked:
            if kv_budget is not None and not req.prefix_counted:
                req.prefix_counted = True
                self.metrics.observe_prefix_cache(hit=req.admit_covered > 0)
            if self.engine.chunked or req.admit_covered:
                recon.append(req)
            else:
                fresh.append(req)
        self._seat_reconstructed(recon)
        self._prefill_fresh(fresh)

    def _prefill_fresh(self, fresh):
        """Ladder: prefill fresh prompts in same-bucket groups, deliver
        each first token, and seat the requests that go on."""
        groups = {}
        for req in fresh:
            groups.setdefault(self.engine.prefill_bucket_for(req.prompt.size),
                              []).append(req)
        for bucket, reqs in sorted(groups.items()):
            prompts = np.zeros((len(reqs), bucket), np.int32)
            lengths = np.zeros((len(reqs),), np.int32)
            for i, req in enumerate(reqs):
                prompts[i, :req.prompt.size] = req.prompt
                lengths[i] = req.prompt.size
            try:
                first, rows = self.engine.prefill(prompts, lengths)
            except Exception as e:    # noqa: BLE001 — isolate to THIS group
                logger.warning("%s: prefill of %d failed: %s: %s",
                               self.name, len(reqs), type(e).__name__, e)
                self.metrics.observe_error(len(reqs))
                for req in reqs:
                    req.fail(BatchExecutionError(
                        f"prefill failed: {type(e).__name__}: {e}"))
                continue
            for i, req in enumerate(reqs):
                self._flag_abandoned(req)
                req.emit(first[i], self.name)
                self.metrics.observe_ttft(req.t_first - req.t_submit)
                self.metrics.observe_gen_tokens(1)
                if req.abandoned:
                    self._resolve(req, "abandoned")
                elif req.eos_id is not None \
                        and int(first[i]) == req.eos_id:
                    self._resolve(req, "eos")
                elif req.max_tokens == 1:
                    self._resolve(req, "length")
                else:
                    try:
                        req.slot = self.engine.admit(first[i], rows[i],
                                                     lengths[i],
                                                     tokens=req.prompt)
                    except InsufficientBlocksError:
                        # the pool raced the budget: the token is out, so
                        # the request continues as a preemption
                        self._preempted.append(req)
                        continue
                    except Exception as e:    # noqa: BLE001 — a device
                        # write failed: fail everything in flight, reset
                        self._fail_all_inflight(
                            e, extra=[req] + reqs[i + 1:])
                        break
                    self._by_slot[req.slot] = req

    def _seat_outcomes(self, reqs, outcomes, deferred, what):
        """Apply ``seat_prefilled`` outcomes: seat, defer (space, not
        failure) into ``deferred``, or fail; a hard failure (a device op
        that may have left the cache half written) fails everything in
        flight and resets the engine."""
        hard, seated = None, []
        for req, out in zip(reqs, outcomes):
            if isinstance(out, InsufficientBlocksError):
                deferred.append(req)
            elif isinstance(out, BaseException):
                hard = out
                self.metrics.observe_error(1)
                req.fail(BatchExecutionError(
                    f"{what} failed: {type(out).__name__}: {out}"))
            else:
                req.slot, req.feed = out
                self._by_slot[req.slot] = req
                seated.append(req)
        if hard is not None:
            self._fail_all_inflight(hard)
        return seated

    def _seat_reconstructed(self, reqs):
        """Seat chunked admissions and paged prefix-cache hits through
        ``engine.seat_prefilled``; pool-dry items defer to ``_waiting``."""
        live = []
        for req in reqs:
            if self._flag_abandoned(req):
                self._resolve(req, "abandoned")
            else:
                live.append(req)
        if live:
            self._seat_outcomes(
                live, self.engine.seat_prefilled([r.prompt for r in live]),
                self._waiting, "seat")

    def _reseat_preempted(self):
        """Re-seat pool-preempted requests (oldest first) from prompt +
        delivered tokens: the teacher-forced feed swallows every
        re-derived emission, so the client's stream continues unchanged.
        Items the pool still cannot hold stay preempted."""
        if not self._preempted or not self.engine.free_slots:
            return
        batch = self._preempted[:self.engine.free_slots]
        self._preempted = self._preempted[len(batch):]
        live = []
        for req in batch:
            if self._flag_abandoned(req):
                self._resolve(req, "abandoned")
            else:
                live.append(req)
        if not live:
            return
        fulls = [np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])
                 for r in live]
        seated = self._seat_outcomes(live, self.engine.seat_prefilled(fulls),
                                     self._preempted,
                                     "re-seat after pool preemption")
        if seated:
            self.metrics.observe_slot_reprefill(len(seated))

    def _load_chunks(self):
        """Arm each feeding slot's next up-to-(K-1)-token chunk, within
        the engine's per-step chunk budget.  A slot that gets no lanes
        still advances one token through its lane 0."""
        kk = self.engine.prefill_chunk
        budget = self.engine.prefill_chunk_budget
        used = 0
        for slot, req in self._by_slot.items():
            if not req.feed or kk < 2:
                continue
            n = min(kk - 1, len(req.feed))
            if budget:
                n = min(n, budget - used)
            if n <= 0:
                continue
            self.engine.load_chunk(slot, req.feed[:n])
            used += n

    def _load_spec(self):
        """Speculating, between steps (after ``_load_chunks``): one
        batched draft rollout drains every active slot's committed-token
        feed, then draft lanes arm for the slots that are purely
        decoding — a slot still ingesting its prompt keeps its prefill
        lanes and joins speculation once its feed drains.  Each verify
        span is capped at the request's remaining emission allowance."""
        budgets = {slot: req.max_tokens - len(req.tokens)
                   for slot, req in self._by_slot.items()
                   if not req.feed and not req.abandoned}
        self.engine.speculate(budgets)

    def _fail_all_inflight(self, e, extra=()):
        """A device operation failed: fail every in-flight request (plus
        ``extra`` ones caught mid-admission) with the cause, reset the
        engine, keep serving."""
        victims = list(self._by_slot.values()) + list(extra)
        logger.warning("%s: device op over %d request(s) failed: %s: %s",
                       self.name, len(victims), type(e).__name__, e)
        self.metrics.observe_error(len(victims))
        for req in victims:
            req.fail(BatchExecutionError(
                f"decode batch failed: {type(e).__name__}: {e}"))
        for _ in self._by_slot:
            self.metrics.evict_slot("error")
        self._by_slot.clear()
        self.engine.reset()

    def _deliver(self, nxt):
        """Deliver each slot's emission: a plain step's one token, or a
        verify step's accepted run (matched drafts, then the target's own
        token at the first mismatch) token by token.  An EOS ends the
        stream there (the engine never advances past what was delivered)
        and ``max_tokens`` can end it mid-run; a surviving stream
        advances past the run in one ``advance``."""
        for slot, req in list(self._by_slot.items()):
            if self._flag_abandoned(req):
                self._finish(req, "abandoned")
                continue
            consumed = self.engine.chunk_len(slot)
            if len(req.feed) >= consumed:
                # still ingesting: this step's emission re-derives a
                # known token — swallow it and feed the context
                self.engine.advance(slot, req.feed[consumed - 1], consumed)
                del req.feed[:consumed]
                continue
            # the feed drained at this step's last lane: its emission is
            # a real one
            del req.feed[:]
            run = self.engine.take_spec_result(slot)
            verify = run is not None
            if verify:
                consumed = len(run)
            else:
                run = [int(nxt[slot])]
            n, done = 0, None
            for tok in run:
                first = req.t_first is None
                req.emit(tok, self.name)
                n += 1
                if first:
                    self.metrics.observe_ttft(req.t_first - req.t_submit)
                    if self.engine.chunked:
                        # the prompt's K/V is fully resident exactly now:
                        # publish it to the paged prefix index (no-op on
                        # slab)
                        self.engine.register_context(slot, req.prompt)
                self.metrics.observe_gen_tokens(1)
                if req.eos_id is not None and tok == req.eos_id:
                    done = "eos"
                elif len(req.tokens) >= req.max_tokens:
                    done = "length"
                if done:
                    break
            if verify:
                self.verify_runs[n] += 1
            if done:
                self._finish(req, done)
            else:
                self.engine.advance(slot, run[-1], consumed)

    def _loop(self):
        while True:
            if self._closed.is_set() and not self._drain:
                for slot, req in list(self._by_slot.items()):
                    req.fail(ShutdownError(
                        "generation batcher closed without drain"))
                    self.engine.evict(slot, "shutdown")
                self._by_slot.clear()
                for req in self._preempted + list(self._waiting):
                    req.fail(ShutdownError(
                        "generation batcher closed without drain"))
                self._preempted, self._waiting = [], collections.deque()
                return
            self._admit_from_queue(block=not self._by_slot)
            if not self._by_slot:
                if self._closed.is_set() and self._q.empty() \
                        and not self._waiting and not self._preempted:
                    return
                if self._waiting or self._preempted:
                    time.sleep(0.005)   # all runnable work is deferred
                continue
            if self.engine.chunked:
                self._load_chunks()
            try:
                if self.engine.speculating:
                    self._load_spec()
                # paged: provision every active slot's write blocks
                # (growth + copy-on-write); a dry pool preempts the
                # youngest slots, whose requests re-seat later
                for slot in self.engine.prepare_step():
                    req = self._by_slot.pop(slot)
                    req.slot = None
                    self._preempted.append(req)
                if not self._by_slot:
                    continue
                nxt = self.engine.step()
            except Exception as e:    # noqa: BLE001 — isolate to the
                # requests in flight; the loop keeps serving
                self._fail_all_inflight(e)
                continue
            self._deliver(nxt)

    # ------------------------------------------------------------ shutdown

    def close(self, drain=True, timeout=60.0):
        """Stop admissions, then finish every queued and in-flight request
        (drain=True) or fail them (drain=False).  Idempotent."""
        with self._admit_lock:
            self._drain = drain
            self._closed.set()
        if self._depth_fn in self.metrics.queue_depth_fns:
            self.metrics.queue_depth_fns.remove(self._depth_fn)
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning("%s: worker did not drain within %.0fs",
                           self.name, timeout)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            self.metrics.reject("shutdown")
            req.fail(ShutdownError("generation batcher closed"))

    @property
    def closed(self):
        return self._closed.is_set()

    @property
    def ready(self):
        return not self._closed.is_set() and self.engine.ready

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
