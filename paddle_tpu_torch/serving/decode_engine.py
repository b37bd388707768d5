"""Continuous-batching generation: the slot-based KV-cache decode engine
and its request front (``paddle_tpu/serving/decode_engine.py``).

* ``DecodeEngine`` — a fixed-shape KV-cache SLAB ``[num_slots, max_len,
  Dkv]`` per layer plus per-slot host state in numpy.  ONE static-shape
  step (``lm_decode_chunk_slots`` + argmax) advances every slot: decode
  rows by one token, admitting rows by up to K prompt tokens (unified
  chunked prefill — prompt ingestion rides the decode step as K-lane
  chunks, their re-derived emissions swallowed until the last chunk,
  whose output is the first real token).  Tokens, positions and lane
  counts are data, so admission and eviction never change the step's
  shapes; they happen between steps, on the host.  The step writes the
  cache in place where the JAX engine donated it.

* ``GenerationBatcher`` — the request front: bounded queue, per-request
  deadlines, continuous admission into free slots, streaming
  ``on_token`` callbacks, graceful drain, and batch-failure isolation (a
  failed step fails only the requests in flight; the engine resets and
  keeps serving).

Greedy decode only (argmax inside the step).  Ported here: the slab
layout with ``prefill_chunk = K > 0`` and a float32 KV cache.  The paged
layout, the legacy prefill ladder (``prefill_chunk=0``), speculative
decoding, tensor-parallel meshes, the host KV tier, int8 KV, supervised
recovery, continuation replay, fault injection and trace spans are not
ported yet (ROADMAP) and raise ``ConfigError`` where they are options.
"""

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.quant.weights import weight_shape as _w_shape
from paddle_tpu_torch.serving.errors import (BatchExecutionError,
                                             DeadlineExceededError,
                                             InvalidRequestError,
                                             OverloadedError, ShutdownError)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.logging import logger


def _not_ported(what):
    return ConfigError(f"{what} not yet ported to paddle_tpu_torch "
                       "(ROADMAP)")


class DecodeEngine:
    """Slot-based continuous-batching decoder over a decoder-only LM trunk
    (``models/transformer`` params).

    params: the trunk dict (moved to ``device``); num_slots: concurrent
    requests the slab holds; max_len: slab length — every request must
    satisfy ``len(prompt) + max_tokens <= max_len``; prefill_chunk: K,
    the token lanes per slot per step (the serving CLI default 8; the
    JAX engine's legacy ``0`` is not ported); prefill_chunk_budget: max
    teacher-forced lanes one step may feed across all slots (0 =
    unbounded); eos_id: default stop token.  device: ``None`` = the
    card (raises without one), or ``"cpu"``.

    Slot lifecycle: FREE -> seated at position 0 (``seat_chunked``) ->
    prompt chunks -> one emitted token per step -> EVICTED (eos | length
    | error | shutdown | abandoned) -> FREE.
    """

    def __init__(self, params, *, num_heads=8, num_slots=8, max_len=256,
                 eos_id=None, moe_top_k=2, pos_type="learned", metrics=None,
                 name="lm", warm=True, kv_layout="slab", prefill_chunk=8,
                 prefill_chunk_budget=0, kv_dtype="float32", speculate_k=0,
                 draft=None, mesh=None, kv_host_bytes=0, device=None):
        if kv_layout != "slab":
            raise _not_ported(f"kv_layout={kv_layout!r} is")
        if not prefill_chunk:
            raise _not_ported("prefill_chunk=0 (the legacy prefill ladder) "
                              "is")
        if kv_dtype != "float32":
            raise _not_ported(f"kv_dtype={kv_dtype!r} is")
        if speculate_k or draft is not None:
            raise _not_ported("speculative decoding (speculate_k, draft) is")
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
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_chunk_budget = int(prefill_chunk_budget or 0)
        if not 0 < self.prefill_chunk <= self.max_len:
            raise ConfigError(f"prefill_chunk={prefill_chunk} must be in "
                              f"[1, max_len={self.max_len}]")
        if self.num_slots < 1:
            raise ConfigError("num_slots must be >= 1")
        self.metrics = metrics or ServingMetrics()
        self.metrics.set_prefill_chunk(self.prefill_chunk)
        # init_lm_cache validates max_len against the positional table
        self._cache = transformer.init_lm_cache(self.params, self.num_slots,
                                                self.max_len)
        # host-side slot state: the K token lanes fed at the NEXT step,
        # the lanes each slot feeds, and lane 0's position.  Free slots
        # idle at (token 0, position 0, 1 lane): their compute is
        # discarded and their cache row is rewritten as a new request
        # advances through it.
        self._tokens = np.zeros((self.num_slots, self.prefill_chunk),
                                np.int32)
        self._len = np.ones((self.num_slots,), np.int32)
        self._pos = np.zeros((self.num_slots,), np.int32)
        self._free = list(range(self.num_slots))[::-1]   # pop() -> slot 0
        self._warm = False
        if warm:
            self.warmup()

    # ------------------------------------------------------------ slots

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
        """Point a slot at (token, position) with one lane for the next
        step."""
        self._tokens[slot, :] = 0
        self._tokens[slot, 0] = token
        self._len[slot] = 1
        self._pos[slot] = pos

    def seat_chunked(self, full):
        """Seat one request for chunked ingestion: arm a free slot at
        (``full[0]``, position 0) and return ``(slot, feed)`` where
        ``feed = full[1:]`` is what the batcher chunk-loads through the
        step.  No device state is touched."""
        if not self._free:
            raise RuntimeError(f"{self.name}: no free decode slot")
        full = np.asarray(full, np.int32)
        slot = self._free.pop()
        self._arm(slot, full[0], 0)
        return slot, [int(t) for t in full[1:]]

    def load_chunk(self, slot, toks):
        """Arm lanes 1..n of ``slot`` for the NEXT step (the next
        teacher-forced prompt tokens after the slot's current token)."""
        n = len(toks)
        if n >= self.prefill_chunk:
            raise RuntimeError(f"{self.name}: load_chunk({n}) needs "
                               f"prefill_chunk > {n} (engine has "
                               f"{self.prefill_chunk})")
        self._tokens[slot, 1:1 + n] = toks
        self._len[slot] = 1 + n
        self.metrics.observe_prefill_chunk(n)

    def chunk_len(self, slot):
        """Lanes the next/current step feeds for ``slot``."""
        return int(self._len[slot])

    def evict(self, slot, reason):
        """Free a slot between steps (its cache row is left as-is; the
        next occupant rewrites each position before unmasking it)."""
        self._arm(slot, 0, 0)
        self._free.append(slot)
        self.metrics.evict_slot(reason)

    def _run(self, tokens, pos, lens):
        """The step on the device: next token per slot as a host array.
        The one host synchronization is the argmax result's copy."""
        dev = self.device
        logits, self._cache = transformer.lm_decode_chunk_slots(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(lens).to(dev),
            self._cache, self.num_heads, self.moe_top_k, self.pos_type)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def step(self):
        """Advance EVERY slot (free slots compute too — fixed shape);
        returns the next token per slot ([num_slots] np.int32).  Callers
        then bump their active slots via ``advance``."""
        tokens, pos, lens = self._tokens.copy(), self._pos.copy(), \
            self._len.copy()
        t0 = time.perf_counter()
        nxt = self._run(tokens, pos, lens)
        self.metrics.observe_decode_step(
            self.num_active, self.num_slots, time.perf_counter() - t0,
            prefill_lanes=int(lens.sum() - self.num_slots))
        return nxt

    def advance(self, slot, token, consumed=1):
        """Record the token fed at the next step for ``slot``, advanced
        past the ``consumed`` lanes the last step processed."""
        self._tokens[slot, 0] = token
        self._len[slot] = 1
        self._pos[slot] += consumed

    def reset(self):
        """Drop all slot state and re-zero the slab (the batch-failure
        isolation path: a failed step must not leak a poisoned slab into
        the next batch)."""
        self._cache = transformer.init_lm_cache(self.params, self.num_slots,
                                                self.max_len)
        self._tokens[:] = 0
        self._pos[:] = 0
        self._len[:] = 1
        self._free = list(range(self.num_slots))[::-1]

    def warmup(self):
        """Run the step once on the idle slab before traffic: on the card
        this builds and loads the kernels, so the first request does not
        pay for ``nvcc``.  No metrics are recorded."""
        if not self._warm:
            self._run(self._tokens, self._pos, self._len)
            self._warm = True
            logger.info("decode[%s]: warm on %s (%d slots, max_len %d, "
                        "chunk K=%d)", self.name, self.device,
                        self.num_slots, self.max_len, self.prefill_chunk)

    # ------------------------------------------------------------ validate

    def validate_request(self, prompt, max_tokens):
        """Admission checks, raised BEFORE the queue: a non-empty 1-D
        in-vocab id sequence, an int max_tokens >= 1, and
        ``len(prompt) + max_tokens <= max_len``."""
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
        return ids.astype(np.int32), max_tokens


class _GenRequest:
    __slots__ = ("prompt", "max_tokens", "eos_id", "future", "deadline",
                 "t_submit", "t_first", "on_token", "tokens", "slot",
                 "abandoned", "feed")

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
        self.feed = []                    # prompt tokens still to ingest

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

    ONE worker thread runs the loop: seat queued requests into free
    slots, arm each ingesting slot's next prompt chunk, run one step,
    deliver each emitting slot's token, evict finished slots.  Admission
    happens strictly between steps, so the step never changes shape.
    The worker issues all device work; the step synchronizes once, on
    the argmax tokens.  ``supervisor`` must be None: supervised
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
        next token boundary."""
        if future.done() or future.cancel():
            return
        for req in list(self._by_slot.values()):
            if req.future is future:
                req.abandoned = True
                return

    # ------------------------------------------------------------ worker

    def _resolve(self, req, reason):
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

    def _admit_from_queue(self, block):
        """Seat queued requests into free slots (strictly between
        steps).  Expired or cancelled requests never take a slot."""
        while self.engine.free_slots:
            try:
                req = (self._q.get(timeout=0.05) if block
                       else self._q.get_nowait())
            except queue.Empty:
                return
            block = False
            now = time.perf_counter()
            if req.deadline is not None and now > req.deadline:
                self.metrics.reject("deadline")
                req.fail(DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{(now - req.t_submit) * 1e3:.1f}ms in queue"))
                continue
            if not req.future.set_running_or_notify_cancel():
                continue        # client cancelled while queued
            req.slot, req.feed = self.engine.seat_chunked(req.prompt)
            self._by_slot[req.slot] = req

    def _load_chunks(self):
        """Arm each ingesting slot's next up-to-(K-1)-token chunk, within
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

    def _fail_all_inflight(self, e):
        """The step failed: fail every in-flight request with the cause,
        reset the engine, keep serving."""
        victims = list(self._by_slot.values())
        logger.warning("%s: step over %d request(s) failed: %s: %s",
                       self.name, len(victims), type(e).__name__, e)
        self.metrics.observe_error(len(victims))
        for req in victims:
            req.fail(BatchExecutionError(
                f"decode batch failed: {type(e).__name__}: {e}"))
            self.metrics.evict_slot("error")
        self._by_slot.clear()
        self.engine.reset()

    def _deliver(self, nxt):
        for slot, req in list(self._by_slot.items()):
            if req.abandoned:
                self._finish(req, "abandoned")
                continue
            consumed = self.engine.chunk_len(slot)
            if len(req.feed) >= consumed:
                # still ingesting: this step's emission re-derives a
                # known prompt token — swallow it and feed the prompt
                self.engine.advance(slot, req.feed[consumed - 1], consumed)
                del req.feed[:consumed]
                continue
            # the feed drained at this step's last lane: its emission is
            # the first real one
            del req.feed[:]
            tok = int(nxt[slot])
            first = req.t_first is None
            req.emit(tok, self.name)
            if first:
                self.metrics.observe_ttft(req.t_first - req.t_submit)
            self.metrics.observe_gen_tokens(1)
            if req.eos_id is not None and tok == req.eos_id:
                self._finish(req, "eos")
            elif len(req.tokens) >= req.max_tokens:
                self._finish(req, "length")
            else:
                self.engine.advance(slot, tok, consumed)

    def _loop(self):
        while True:
            if self._closed.is_set() and not self._drain:
                for slot, req in list(self._by_slot.items()):
                    req.fail(ShutdownError(
                        "generation batcher closed without drain"))
                    self.engine.evict(slot, "shutdown")
                self._by_slot.clear()
                return
            self._admit_from_queue(block=not self._by_slot)
            if not self._by_slot:
                if self._closed.is_set() and self._q.empty():
                    return
                continue
            self._load_chunks()
            try:
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
