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
refcount ledger (no leak, no double free, pending restore claims
included).  Seating, truncation and restore claims are the trace
instants ``kv.seat``, ``kv.seat_shared``, ``kv.truncate`` and
``kv.restore_claim`` (``obs/trace.py``; no-ops when tracing is off).

The host tier below the pool: ``HostTier`` is an LRU byte-capped
host-RAM store of SPILLED prefix chains.  When ``PrefixIndex.evict_lru``
drops an entry under pool pressure, its ``on_evict`` hook (the engine's)
gathers the chain's blocks and ``serialize_chain``s them into the tier
under the same block-aligned key; a later prompt that would recompute
that prefix restores it instead (the tier's transfer thread stages the
payload while steps run) into freshly claimed blocks (``claim_pending``)
and seats by reference like any resident hit.  ``serialize_chain`` /
``restore_chain`` are the relocatable wire format (version byte + trunk
signature) the cross-replica handoff (``serving/transfer.py``) ships:
plain numpy and JSON, byte for byte the JAX package's format.
"""

import collections
import json
import threading

import numpy as np

from paddle_tpu_torch.obs import trace as obstrace
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger

SCRATCH_BLOCK = 0

# serialize_chain's wire-format version, byte 0 of every blob: bumped on
# any layout change, and restore_chain rejects other versions
WIRE_VERSION = 1

# decoded-blob ceiling at the network boundary (serving/transfer.py): a
# garbled or hostile peer's length prefix or manifest must never drive an
# allocation.  The host tier's own cap is separate; this bounds one blob.
MAX_CHAIN_BLOB_BYTES = 1 << 30


class WireFormatError(ValueError):
    """A chain blob violates the ``serialize_chain`` wire format
    (truncated, oversized, inconsistent manifest, foreign trunk)."""


class WireVersionError(WireFormatError):
    """The blob's version byte (or header version) is not
    ``WIRE_VERSION``: an explicit mismatch, never a silent misparse."""


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


class RestorePendingError(InsufficientBlocksError):
    """A host-tier restore covering this request's prefix is in flight
    (blocks claimed, payload staging): seating now would recompute what
    the transfer is about to deliver.  An ``InsufficientBlocksError`` so
    every defer-and-retry seam treats it as "space, not failure"; the
    retry after the commit seats an ordinary resident hit."""


def serialize_chain(tokens, covered, arrays, trunk_sig):
    """Pack one prefix chain's K/V into a RELOCATABLE blob: the prefix
    key ``tokens``, the positions it covers, and each cache leaf's
    gathered block rows (``arrays``: ``(name, ndarray)`` pairs; int8 codes
    plus f32 scales on a quantized cache) as raw bytes behind a JSON
    manifest.  No block ids: a restore lands the payload in whatever
    blocks the destination pool hands out.

    Layout: 1 version byte, an 8-byte little-endian header length, the
    JSON header ``{version, trunk_sig, tokens, covered, arrays: [{name,
    dtype, shape}...]}`` (keys sorted), then each array's C-order bytes
    in manifest order.  ``trunk_sig`` fingerprints the producing trunk;
    ``restore_chain`` rejects a mismatch."""
    arrays = list(arrays)
    header = {
        "version": WIRE_VERSION,
        "trunk_sig": str(trunk_sig),
        "tokens": [int(t) for t in tokens],
        "covered": int(covered),
        "arrays": [{"name": str(n), "dtype": str(a.dtype),
                    "shape": [int(s) for s in a.shape]}
                   for n, a in arrays],
    }
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    parts = [bytes([WIRE_VERSION]), len(hdr).to_bytes(8, "little"), hdr]
    for _n, a in arrays:
        parts.append(np.ascontiguousarray(a).tobytes())
    return b"".join(parts)


def peek_chain_header(blob, trunk_sig=None, max_bytes=None):
    """Parse and validate only the blob's envelope (version byte, header
    length, JSON header, optional trunk signature and size bound) without
    touching the payload; returns the header dict.  Raises
    ``WireVersionError`` on a version mismatch, ``WireFormatError`` on
    anything else."""
    if max_bytes is not None and len(blob) > int(max_bytes):
        raise WireFormatError(
            f"chain blob of {len(blob)} byte(s) exceeds the "
            f"{int(max_bytes)}-byte receive bound")
    if len(blob) < 9:
        raise WireFormatError(
            f"chain blob truncated: {len(blob)} byte(s)")
    if blob[0] != WIRE_VERSION:
        raise WireVersionError(f"chain blob version {blob[0]} != "
                               f"{WIRE_VERSION} (wire format mismatch)")
    hlen = int.from_bytes(blob[1:9], "little")
    if 9 + hlen > len(blob):
        raise WireFormatError("chain blob header overruns the payload")
    try:
        header = json.loads(blob[9:9 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(f"chain blob header is not valid JSON: "
                              f"{e}") from None
    if not isinstance(header, dict):
        raise WireFormatError("chain blob header is not a JSON object")
    if header.get("version") != WIRE_VERSION:
        raise WireVersionError(
            f"chain header version {header.get('version')} "
            f"!= {WIRE_VERSION}")
    if trunk_sig is not None and header.get("trunk_sig") != str(trunk_sig):
        raise WireFormatError(
            f"chain trunk signature {header.get('trunk_sig')!r} does not "
            f"match this engine's {str(trunk_sig)!r}: K/V bytes are only "
            "relocatable between identical trunks")
    return header


def restore_chain(blob, trunk_sig, max_bytes=None):
    """Inverse of ``serialize_chain``: ``(tokens_tuple, covered,
    [(name, ndarray), ...])`` (read-only views of ``blob``).  Raises
    ``WireVersionError`` / ``WireFormatError`` on a version or signature
    mismatch, a truncated or oversized payload, or trailing bytes;
    ``max_bytes`` bounds the blob before any manifest-driven decoding
    (None = a trusted local blob)."""
    header = peek_chain_header(blob, trunk_sig, max_bytes)
    hlen = int.from_bytes(blob[1:9], "little")
    off = 9 + hlen
    arrays = []
    for spec in header["arrays"]:
        try:
            dt = np.dtype(spec["dtype"])
            shape = tuple(int(s) for s in spec["shape"])
        except (TypeError, ValueError, KeyError) as e:
            raise WireFormatError(
                f"chain blob manifest is malformed: {e}") from None
        if any(s < 0 for s in shape):
            raise WireFormatError(
                f"chain blob array {spec.get('name')!r} declares a "
                "negative dimension")
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = dt.itemsize * count
        if off + nbytes > len(blob):
            raise WireFormatError(f"chain blob truncated inside array "
                                  f"{spec['name']!r}")
        arrays.append((spec["name"],
                       np.frombuffer(blob, dt, count=count,
                                     offset=off).reshape(shape)))
        off += nbytes
    if off != len(blob):
        raise WireFormatError(f"chain blob holds {len(blob) - off} "
                              "trailing byte(s) past the manifest")
    return tuple(header["tokens"]), int(header["covered"]), arrays


class HostTier:
    """LRU host-RAM store of spilled prefix-chain blobs, byte-capped.

    Keyed by the prefix index's block-aligned keys; ``put`` evicts the
    stalest blobs until the new one fits ``cap_bytes`` (0 = no cap) —
    what falls off simply recomputes, as with no tier.  The tier also
    owns the background transfer thread restores stage on
    (``data/prefetch.TransferWorker``): the engine submits a job and
    polls completions strictly between steps.  The map is lock-guarded:
    spills and probes run on the batcher's worker thread while
    ``/metrics`` reads the byte gauge from HTTP threads."""

    def __init__(self, cap_bytes=0, worker_depth=8):
        if int(cap_bytes) < 0:
            raise ConfigError(f"HostTier cap_bytes must be >= 0, got "
                              f"{cap_bytes}")
        self.cap_bytes = int(cap_bytes)
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # key -> (covered, blob)
        self._bytes = 0
        self._worker_depth = int(worker_depth)
        self._worker = None         # started by the first submit

    def __len__(self):
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self):
        """Resident payload bytes (the host_tier_bytes gauge)."""
        with self._lock:
            return self._bytes

    def put(self, key, covered, blob):
        """Insert (or refresh) one spilled chain, dropping the entries
        whose keys are strict prefixes of ``key`` (its payload supersets
        theirs) and then LRU entries until the tier fits its cap; returns
        the number dropped for the cap."""
        key = tuple(int(t) for t in key)
        dropped = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[1])
            for k in [k for k in self._entries
                      if len(k) < len(key) and key[:len(k)] == k]:
                _cov, shadowed = self._entries.pop(k)
                self._bytes -= len(shadowed)
            self._entries[key] = (int(covered), blob)
            self._bytes += len(blob)
            while self.cap_bytes and self._bytes > self.cap_bytes \
                    and self._entries:
                _k, (_cov, dropped_blob) = self._entries.popitem(
                    last=False)
                self._bytes -= len(dropped_blob)
                dropped += 1
        return dropped

    def pop(self, key):
        """Remove and return ``(covered, blob)`` for ``key``, or None."""
        with self._lock:
            ent = self._entries.pop(tuple(int(t) for t in key), None)
            if ent is not None:
                self._bytes -= len(ent[1])
            return ent

    def covers(self, key):
        """True if a stored key EXTENDS ``key`` (equal or longer, same
        leading tokens): a spill of ``key`` would be redundant."""
        key = tuple(int(t) for t in key)
        n = len(key)
        with self._lock:
            return any(len(k) >= n and k[:n] == key
                       for k in self._entries)

    def lookup(self, tokens, block_size):
        """Longest spilled coverage of ``tokens``: the exact probe first,
        then block-aligned prefixes descending.  ``(key, covered, blob)``
        or ``(None, 0, None)``; a hit is an LRU touch and stays resident
        until its restore commits."""
        bs = int(block_size)
        toks = tuple(int(t) for t in tokens)
        with self._lock:
            ent = self._entries.get(toks)
            if ent is not None:
                self._entries.move_to_end(toks)
                return toks, ent[0], ent[1]
            for m in range(len(toks) // bs, 0, -1):
                ent = self._entries.get(toks[:m * bs])
                if ent is not None:
                    self._entries.move_to_end(toks[:m * bs])
                    return toks[:m * bs], ent[0], ent[1]
        return None, 0, None

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def submit(self, tag, fn):
        """Run ``fn`` on the tier's transfer thread; the result comes
        back from ``poll()`` as ``(tag, result)``."""
        if self._worker is None:
            from paddle_tpu_torch.data.prefetch import TransferWorker
            self._worker = TransferWorker(name="paddle-tpu-kv-restore",
                                          depth=self._worker_depth)
        self._worker.submit(tag, fn)

    def poll(self, timeout=0.0):
        """The next completed job ``(tag, result)`` or None; ``result``
        may be a ``prefetch._Failure`` (the engine decides its fate)."""
        if self._worker is None:
            return None
        return self._worker.poll(timeout=timeout)

    def close(self):
        if self._worker is not None:
            self._worker.close()
            self._worker = None


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
    releases the stalest entry's references, handing the entry to the
    ``on_evict`` spill hook first (the engine's: it reads the blocks while
    they are still owned)."""

    def __init__(self, pool, on_evict=None):
        self._pool = pool
        self._on_evict = on_evict
        self._entries = collections.OrderedDict()  # key -> (covered, [bids])

    def __len__(self):
        return len(self._entries)

    def keys(self):
        """The registered prefix keys (read-only view)."""
        return self._entries.keys()

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
        key, (cov, chain) = self._entries.popitem(last=False)
        if self._on_evict is not None:
            try:
                self._on_evict(key, cov, list(chain))
            except Exception as e:  # noqa: BLE001 — a spill failure
                # loses the spill, never the eviction: pool pressure
                # always makes progress
                logger.warning("prefix spill of %d block(s) failed: "
                               "%s: %s", len(chain), type(e).__name__, e)
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
                 prefix_cache=True, on_evict=None):
        self.pool = BlockPool(num_blocks, block_size)
        self.index = (PrefixIndex(self.pool, on_evict=on_evict)
                      if prefix_cache else None)
        self.block_size = self.pool.block_size
        self.blocks_per_row = -(-int(max_len) // self.block_size)
        self.tables = np.zeros((int(num_slots), self.blocks_per_row),
                               np.int32)
        self._chains = [[] for _ in range(int(num_slots))]
        # host-tier restores in flight: prefix key -> [bids] claimed ahead
        # of the transfer (held here so the pool never hands them out
        # twice; committed into the index, or released, when it lands)
        self._pending = {}
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
        obstrace.instant("kv.seat", slot=slot, blocks=len(chain),
                         free=self.pool.num_free)
        return chain

    def seat_shared(self, slot, chain, n_positions):
        """Seat a prefix-cache hit: take shared references on
        ``chain[:blocks_for(n_positions)]`` — no prefill, no copy; the
        first divergent write forks in ``write_plan``."""
        take = [self.pool.share(b)
                for b in chain[:self.blocks_for(n_positions)]]
        self._install(slot, take)
        obstrace.instant("kv.seat_shared", slot=slot, blocks=len(take),
                         free=self.pool.num_free)
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

    # ------------------------------------------------------ host-tier restore

    def claim_pending(self, key, n_positions):
        """Claim ``blocks_for(n_positions)`` fresh blocks for a host-tier
        restore of prefix ``key``, held in the pending ledger (refcount
        1, outside every slot chain) until the transfer lands.
        All-or-nothing; raises ``InsufficientBlocksError`` with nothing
        claimed."""
        key = tuple(int(t) for t in key)
        if key in self._pending:
            raise RuntimeError(f"restore of {len(key)}-token prefix "
                               "already in flight")
        need = self.blocks_for(n_positions)
        chain = []
        for _ in range(need):
            bid = self._alloc()
            if bid is None:
                for b in chain:
                    self.pool.release(b)
                raise InsufficientBlocksError(
                    f"pool dry claiming {need} block(s) for a host-tier "
                    f"restore ({self.pool.num_free} free)")
            chain.append(bid)
        self._pending[key] = chain
        obstrace.instant("kv.restore_claim", blocks=len(chain),
                         free=self.pool.num_free)
        return list(chain)

    def release_pending(self, key):
        """Drop a claim whose restore died."""
        chain = self._pending.pop(tuple(int(t) for t in key), None)
        if chain:
            for bid in chain:
                self.pool.release(bid)

    def commit_pending(self, key, covered):
        """The restore landed: publish the chain into the prefix index
        (the entry takes its own references) and drop the claim.  If the
        key was recomputed into the index meanwhile, the existing entry
        wins (identical K/V) and the restored blocks free."""
        key = tuple(int(t) for t in key)
        chain = self._pending.pop(key)
        if self.index is not None:
            self.index._add(key, int(covered), chain)
        for bid in chain:
            self.pool.release(bid)

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
        if dropped:
            obstrace.instant("kv.truncate", slot=slot, blocks=dropped,
                             free=self.pool.num_free)
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
        slot-chain, pending-claim and index references to it, and the pool's own
        free/held partition holds."""
        self.pool.check()
        expect = collections.Counter()
        for chain in self._chains:
            expect.update(chain)
        for chain in self._pending.values():
            expect.update(chain)
        if self.index is not None:
            for chain in self.index.chains():
                expect.update(chain)
        for bid in range(1, self.pool.num_blocks):
            if self.pool.refcount(bid) != expect.get(bid, 0):
                raise AssertionError(
                    f"block {bid}: refcount {self.pool.refcount(bid)} != "
                    f"{expect.get(bid, 0)} ledger references")
