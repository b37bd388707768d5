"""Paged KV cache, host half: block-pool allocator + copy-on-write prefix
sharing (``paddle_tpu/serving/kv_pool.py``).

* ``BlockPool`` — a fixed pool of ``num_blocks`` KV blocks of
  ``block_size`` positions each (the device tensors live in the engine:
  per layer ``[num_blocks, block_size, Dkv]``,
  ``transformer.init_lm_cache_paged``).  Free-list allocation with
  per-block REFCOUNTS: a block referenced by several slot chains and/or
  the prefix index stays resident until the last reference releases it.
  Block 0 is the scratch block free slot rows point at; allocatable ids
  are ``1..num_blocks-1``.

* ``PrefixIndex`` — block-aligned prompt prefixes (plus the exact full
  prompt when its tail block is partial) -> the resident block chains
  holding their K/V, LRU.  A request whose prompt starts with a cached
  prefix admits by taking references to those blocks instead of
  recomputing them.

* ``PagedKVState`` — per-engine bookkeeping: the per-slot block tables
  (``[num_slots, blocks_per_row]`` int32, uploaded to the step as data),
  per-slot chains, and the write-exclusivity rule that yields
  COPY-ON-WRITE: a slot about to write into a block whose refcount
  exceeds 1 first forks it (the engine copies the block on the device and
  the table entry swaps to the private copy).

Everything here is host-side numpy between steps; ``check()`` audits the
refcount ledger (no leak, no double free).  Not ported (ROADMAP): the
host spill tier, the chain wire format and the pending-restore ledger.
"""

import collections

import numpy as np

from paddle_tpu_torch.utils.error import ConfigError

SCRATCH_BLOCK = 0


def slab_equivalent_blocks(num_slots, max_len, block_size,
                           kv_dtype="float32"):
    """Auto pool size (``DecodeEngine(kv_num_blocks=0)``) at the float32
    slab's byte budget: ``num_slots * ceil(max_len / block_size)``
    blocks (the same KV bytes, strictly more packable).  ``kv_dtype=
    "int8"`` doubles the count inside that budget: an int8 block and its
    f32 scale sidecar cost ``1/4 + 1/head_dim`` of a float32 block
    (``quant/kv.kv_bytes_per_position``), at most half for head_dim >= 4.
    +1 for the scratch block."""
    per_row = -(-int(max_len) // int(block_size))
    blocks = int(num_slots) * per_row
    if kv_dtype == "int8":
        blocks *= 2
    return blocks + 1


class InsufficientBlocksError(RuntimeError):
    """The pool cannot supply the requested blocks even after evicting
    every prefix-index entry.  Admission defers the request (it is NOT a
    client error); mid-decode the engine preempts a victim slot instead
    (``evictions{reason="pool_exhausted"}``)."""


class BlockPool:
    """Free-list + refcount allocator over ``num_blocks`` KV blocks.

    ``alloc()`` hands out a block at refcount 1; ``share()`` adds a
    reference; ``release()`` drops one and returns the block to the free
    list at zero."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ConfigError("BlockPool needs num_blocks >= 2 (block 0 "
                              "is the reserved scratch block)")
        if block_size < 1:
            raise ConfigError("BlockPool needs block_size >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # pop() -> block 1 first; scratch block 0 is never allocatable
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = np.zeros((self.num_blocks,), np.int64)

    @property
    def num_allocatable(self):
        return self.num_blocks - 1

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        return self.num_allocatable - len(self._free)

    def refcount(self, bid):
        return int(self._ref[bid])

    def alloc(self):
        """One free block at refcount 1, or None when the pool is dry
        (callers then evict prefix-index entries / preempt a slot)."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def share(self, bid):
        if self._ref[bid] < 1:
            raise RuntimeError(f"BlockPool.share of unowned block {bid}")
        self._ref[bid] += 1
        return bid

    def release(self, bid):
        if self._ref[bid] < 1:
            raise RuntimeError(f"BlockPool.release of free block {bid} "
                               "(double free)")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)

    def check(self):
        """The free list and the refcounts partition the allocatable ids
        exactly; raises AssertionError otherwise."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds duplicates: "
                                 f"{sorted(self._free)}")
        if SCRATCH_BLOCK in free or self._ref[SCRATCH_BLOCK] != 0:
            raise AssertionError("scratch block 0 entered the allocator")
        held = {int(b) for b in np.nonzero(self._ref)[0]}
        if free & held:
            raise AssertionError(f"blocks both free and referenced: "
                                 f"{sorted(free & held)}")
        if len(free) + len(held) != self.num_allocatable:
            raise AssertionError(
                f"leaked blocks: {self.num_allocatable} allocatable != "
                f"{len(free)} free + {len(held)} held")


class PrefixIndex:
    """Prompt prefix -> resident block chain, LRU.

    Two key kinds share one map: every BLOCK-ALIGNED prefix of a
    registered prompt (reusable by any prompt sharing those leading
    blocks), plus the EXACT full prompt when its tail block is partial
    (reusable by exact duplicates only — a longer probe matches just the
    aligned portion).  An entry holds ONE pool reference per block, so the
    chain outlives the slot that wrote it.  ``lookup`` returns the longest
    registered coverage of the probe (an LRU touch); ``evict_lru``
    releases the stalest entry's references."""

    def __init__(self, pool):
        self._pool = pool
        self._entries = collections.OrderedDict()  # key -> (covered, [bids])

    def __len__(self):
        return len(self._entries)

    def chains(self):
        """Every entry's block chain (read-only view for audits)."""
        return [chain for _cov, chain in self._entries.values()]

    def _add(self, key, covered, blocks):
        if key in self._entries:
            # existing entries win — their blocks hold identical K/V by
            # determinism, and keeping them preserves their sharers
            self._entries.move_to_end(key)
            return
        self._entries[key] = (covered, [self._pool.share(b)
                                        for b in blocks])

    def register(self, tokens, chain):
        """Publish ``tokens`` (the real prefix of an admitted prompt whose
        K/V ``chain`` holds): every block-aligned prefix, plus the exact
        full key when the tail block is partial."""
        bs = self._pool.block_size
        toks = tuple(int(t) for t in tokens)
        for m in range(1, len(toks) // bs + 1):
            self._add(toks[:m * bs], m * bs, chain[:m])
        if len(toks) % bs:
            self._add(toks, len(toks), chain[:-(-len(toks) // bs)])

    def lookup(self, tokens):
        """Longest registered coverage of ``tokens``: the exact probe
        first, then block-aligned prefixes descending.  Returns
        ``(covered_positions, [bids])`` or ``(0, [])``; references are
        NOT taken here — seating does."""
        bs = self._pool.block_size
        toks = tuple(int(t) for t in tokens)
        ent = self._entries.get(toks)
        if ent is not None:
            self._entries.move_to_end(toks)
            return ent[0], list(ent[1])
        for m in range(len(toks) // bs, 0, -1):
            ent = self._entries.get(toks[:m * bs])
            if ent is not None:
                self._entries.move_to_end(toks[:m * bs])
                return ent[0], list(ent[1])
        return 0, []

    def evict_lru(self):
        """Release the stalest entry's block references; True if one was
        evicted."""
        if not self._entries:
            return False
        _key, (_cov, chain) = self._entries.popitem(last=False)
        for bid in chain:
            self._pool.release(bid)
        return True


class PagedKVState:
    """Host bookkeeping for one paged ``DecodeEngine``: pool + prefix
    index + per-slot block tables/chains + the write-exclusivity plan.

    The engine owns every device operation (the step, block writes, block
    copies); this object only decides WHICH blocks — methods that need a
    device copy return the plan and the engine executes it."""

    def __init__(self, num_slots, num_blocks, block_size, max_len,
                 prefix_cache=True):
        self.pool = BlockPool(num_blocks, block_size)
        self.index = PrefixIndex(self.pool) if prefix_cache else None
        self.block_size = self.pool.block_size
        self.blocks_per_row = -(-int(max_len) // self.block_size)
        self.tables = np.zeros((int(num_slots), self.blocks_per_row),
                               np.int32)
        self._chains = [[] for _ in range(int(num_slots))]
        # admission order, for pool-pressure victim choice (youngest
        # first: cheapest replay, most blocks still ahead of it)
        self._seat_seq = np.zeros((int(num_slots),), np.int64)
        self._seq = 0

    # ------------------------------------------------------------ sizing

    def blocks_for(self, n_positions):
        return -(-int(n_positions) // self.block_size)

    def can_admit(self, n_positions):
        """Could ``blocks_for(n_positions)`` blocks be produced right now
        (free list + whatever evicting the whole prefix index would
        release)?  Conservative: index blocks shared by live slots count
        as unevictable."""
        need = self.blocks_for(n_positions)
        free = self.pool.num_free
        if free >= need:
            return True
        if self.index is None:
            return False
        live = {b for c in self._chains for b in c}
        evictable = {b for chain in self.index.chains() for b in chain
                     if b not in live and self.pool.refcount(b) >= 1}
        return free + len(evictable) >= need

    def _alloc(self):
        """One block, evicting LRU prefix entries under pressure; None
        when truly dry (the caller preempts a slot)."""
        bid = self.pool.alloc()
        while bid is None and self.index is not None \
                and self.index.evict_lru():
            bid = self.pool.alloc()
        return bid

    # ------------------------------------------------------------ seating

    def seat_fresh(self, slot, n_positions):
        """Claim private blocks covering ``[0, n_positions)``; returns the
        chain.  All-or-nothing: on exhaustion nothing is claimed and
        ``InsufficientBlocksError`` raises."""
        need = self.blocks_for(n_positions)
        chain = []
        for _ in range(need):
            bid = self._alloc()
            if bid is None:
                for b in chain:
                    self.pool.release(b)
                raise InsufficientBlocksError(
                    f"pool dry: {need} block(s) wanted, "
                    f"{self.pool.num_free} free")
            chain.append(bid)
        self._install(slot, chain)
        return chain

    def seat_shared(self, slot, chain, n_positions):
        """Seat a prefix-cache hit: take shared references on
        ``chain[:blocks_for(n_positions)]`` — no prefill, no copy; the
        first divergent write forks in ``write_plan``."""
        take = [self.pool.share(b)
                for b in chain[:self.blocks_for(n_positions)]]
        self._install(slot, take)
        return take

    def _install(self, slot, chain):
        if self._chains[slot]:
            raise RuntimeError(f"slot {slot} already holds a chain")
        self._chains[slot] = chain
        self.tables[slot, :len(chain)] = chain
        self._seq += 1
        self._seat_seq[slot] = self._seq

    def register_prefix(self, tokens, slot):
        """Publish the seated slot's prompt prefixes into the index (no-op
        with the prefix cache off)."""
        if self.index is not None:
            self.index.register(tokens, self._chains[slot])

    def lookup_prefix(self, tokens):
        if self.index is None:
            return 0, []
        return self.index.lookup(tokens)

    # ------------------------------------------------------------ stepping

    def write_plan(self, slot, position):
        """Make ``position`` writable for ``slot`` before the next step.
        Returns None (already exclusive), ``("alloc", j, bid)`` (the chain
        grew into a fresh block), or ``("cow", j, src, dst)`` — the engine
        must copy block ``src`` into ``dst`` on the device (``src`` stays
        resident for its other sharers).  Raises
        ``InsufficientBlocksError`` when the pool is dry."""
        j = position // self.block_size
        chain = self._chains[slot]
        if j > len(chain):
            raise RuntimeError(
                f"slot {slot} chain has {len(chain)} block(s) but writes "
                f"block {j}: positions were skipped")
        if j == len(chain):
            bid = self._alloc()
            if bid is None:
                raise InsufficientBlocksError(
                    f"pool dry growing slot {slot} to block {j}")
            chain.append(bid)
            self.tables[slot, j] = bid
            return ("alloc", j, bid)
        src = chain[j]
        if self.pool.refcount(src) == 1:
            return None
        dst = self._alloc()
        if self.pool.refcount(src) == 1:
            # _alloc's LRU evictions dropped the last OTHER reference
            # (the sharer was the index): the block is exclusive after
            # all — no fork
            if dst is not None:
                self.pool.release(dst)
            return None
        if dst is None:
            raise InsufficientBlocksError(
                f"pool dry forking shared block {src} for slot {slot}")
        self.pool.release(src)      # our reference moves to the fork
        chain[j] = dst
        self.tables[slot, j] = dst
        return ("cow", j, src, dst)

    def truncate(self, slot, n_positions):
        """Roll ``slot``'s chain back to the blocks covering
        ``[0, n_positions)``; returns the number of blocks released (a
        shared tail block only drops this slot's reference)."""
        keep = self.blocks_for(n_positions)
        chain = self._chains[slot]
        dropped = 0
        while len(chain) > keep:
            bid = chain.pop()
            self.tables[slot, len(chain)] = SCRATCH_BLOCK
            self.pool.release(bid)
            dropped += 1
        return dropped

    def victim(self, exclude):
        """Youngest active slot outside ``exclude`` (pool-pressure
        preemption order), or None."""
        best, best_seq = None, -1
        for s, chain in enumerate(self._chains):
            if chain and s not in exclude \
                    and self._seat_seq[s] > best_seq:
                best, best_seq = s, self._seat_seq[s]
        return best

    # ------------------------------------------------------------ teardown

    def evict(self, slot):
        """Release the slot's chain (shared blocks stay resident for their
        other sharers / the index) and point its table row at scratch."""
        for bid in self._chains[slot]:
            self.pool.release(bid)
        self._chains[slot] = []
        self.tables[slot, :] = SCRATCH_BLOCK

    def check(self):
        """Full ledger audit: every block's refcount equals the number of
        slot-chain plus index references to it, and the pool's own
        free/held partition holds."""
        self.pool.check()
        expect = collections.Counter()
        for chain in self._chains:
            expect.update(chain)
        if self.index is not None:
            for chain in self.index.chains():
                expect.update(chain)
        for bid in range(1, self.pool.num_blocks):
            if self.pool.refcount(bid) != expect.get(bid, 0):
                raise AssertionError(
                    f"block {bid}: refcount {self.pool.refcount(bid)} != "
                    f"{expect.get(bid, 0)} ledger references")
