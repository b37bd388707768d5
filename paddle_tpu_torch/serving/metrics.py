"""Live serving metrics — ``paddle_tpu/serving/metrics.py::
ServingMetrics`` less the sharded-decode, fleet-role and engine-cache
gauges: request/response/rejection counters; the inference plane's
batches, occupancy and padding waste (``observe_batch``); TTFT, per-step
time (TPOT), slot occupancy, chunked-prefill lanes, slot evictions, the
paged KV pool's gauges and prefix-sharing counters, the KV cache's
storage dtype, speculative decoding's draft lanes and acceptance; the
host tier's spills, restores and resident bytes, cross-replica handoffs
by outcome; the resilience events (transient-submit retries, watchdog
trips, re-seated slots, the circuit breaker's state) and the injected
faults fired by point (``fault_injections_total``,
``resilience/faults.fired_counts``).

One instance is shared by the engine, the batcher and the HTTP front-end.
``render_prometheus()`` is the ``/metrics`` text; ``snapshot()`` the same
data as a dict."""

import threading

from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.stats import Histogram

# submit() rejection reasons — keys are part of the /metrics surface.
# breaker = the circuit breaker is open (resilience/supervisor.py)
REJECT_REASONS = ("overload", "deadline", "invalid", "shutdown", "breaker")

# decode-slot eviction reasons: eos = the model emitted the stop token,
# length = max_tokens reached, error = the slot's request failed with its
# step, shutdown = close(drain=False), abandoned = the caller went away,
# recovered = a failed step tore the slot down and supervised recovery
# re-seated it on the rebuilt cache (resilience/supervisor.py),
# pool_exhausted = the paged KV pool ran dry and the slot was preempted
# (its request re-seats and continues)
EVICT_REASONS = ("eos", "length", "error", "shutdown", "abandoned",
                 "recovered", "pool_exhausted")

# cross-replica KV handoff outcomes (serving/transfer.py): sent = this
# replica exported a chain, received = a peer's blob was fetched into the
# host tier, fallback = the handoff was skipped or failed and the stream
# recomputed its context (the same tokens either way)
HANDOFF_OUTCOMES = ("sent", "received", "fallback")

# circuit-breaker state gauge encoding (breaker_state)
BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}

_QUANTILES = (50, 95, 99)


class ServingMetrics:
    """Thread-safe counters + latency histograms for one engine."""

    def __init__(self, name="paddle_tpu_torch_serving", max_samples=100000):
        self.name = name
        self._lock = threading.Lock()
        self.requests_total = 0          # accepted into the queue
        self.responses_total = 0         # futures resolved with a result
        self.errors_total = 0            # futures failed by a step error
        self.rejected = {r: 0 for r in REJECT_REASONS}
        # the inference plane (serving/engine.py): executed batches, their
        # real rows and padded bucket slots, and each batch's time
        self.batches_total = 0
        self.batch_rows_total = 0
        self.batch_slots_total = 0
        self.batch_time = Histogram(f"{name}_batch_time", max_samples)
        # request wall latency submit -> future resolved (seconds)
        self.latency = Histogram(f"{name}_latency", max_samples)
        # time to first token: submit -> the request's first emission
        self.ttft = Histogram(f"{name}_ttft", max_samples)
        # one decode step's wall time — every active request emits at most
        # one token per step, so this is the per-token latency of a stream
        self.tpot = Histogram(f"{name}_tpot", max_samples)
        self.gen_tokens_total = 0        # delivered tokens
        self.decode_steps_total = 0
        self.active_slot_steps_total = 0  # sum of active slots over steps
        self.slot_count = 0              # gauge, set by the engine
        self.prefill_chunks_total = 0    # chunks loaded into steps
        self.prefill_chunk_lanes_total = 0  # teacher-forced lanes loaded
        self.prefill_lane_steps_total = 0   # sum of per-step chunk lanes
        self.prefill_chunk_size = 0      # gauge: engine K
        self.evictions = {r: 0 for r in EVICT_REASONS}
        # speculative decoding (serving/speculative.py): draft lanes
        # scored by verify steps and how many the target accepted
        self.speculate_k = 0             # gauge: draft lanes a slot (0=off)
        self.drafted_tokens_total = 0    # draft lanes scored
        self.accepted_tokens_total = 0   # draft lanes accepted (matched)
        self.spec_steps_total = 0        # steps that verified >= 1 span
        self.spec_slot_steps_total = 0   # speculating slots summed over steps
        # paged KV cache: block-pool gauges (set by the engine after each
        # step) and prefix-sharing / copy-on-write counters
        self.kv_blocks_total = 0         # gauge: allocatable pool blocks
        self.kv_blocks_free = 0          # gauge: free-list depth
        self.kv_dtype = "float32"        # gauge: cache storage dtype
        #                                  ("int8" = quantized serving)
        self.prefix_cache_hits = 0       # fresh admissions seated from
        #                                  resident prefix blocks
        self.prefix_cache_misses = 0     # fresh admissions that prefilled
        self.cow_forks = 0               # copy-on-write block forks
        self.slot_reprefills_total = 0   # preempted or recovered slots
        #                                  re-seated
        # the host KV tier (kv_host_bytes): prefix chains spilled to host
        # RAM at eviction and restored instead of recomputed
        self.kv_spill_blocks_total = 0   # blocks serialized to the tier
        self.kv_restore_hits_total = 0   # spilled chains restored
        self.kv_restore_bytes_total = 0  # payload bytes restored
        self.host_tier_bytes = 0         # gauge: resident spilled bytes
        self.kv_restore = Histogram(f"{name}_kv_restore", max_samples)
        # cross-replica handoffs (serving/transfer.py)
        self.kv_handoffs = {o: 0 for o in HANDOFF_OUTCOMES}
        self.kv_handoff_bytes_total = 0  # blob bytes sent + received
        self.kv_handoff = Histogram(f"{name}_kv_handoff", max_samples)
        # resilience (resilience/supervisor.py)
        self.retries_total = 0           # transient submit retries taken
        self.watchdog_trips_total = 0    # step deadline misses
        self.breaker_open_total = 0      # times the breaker tripped open
        self.breaker_state = 0           # gauge: 0 closed/1 half-open/2 open
        # each batcher contributes a zero-arg callable -> its queue depth
        self.queue_depth_fns = []

    # ------------------------------------------------------------ record

    def accepted(self):
        with self._lock:
            self.requests_total += 1

    def reject(self, reason):
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def observe_batch(self, n_real, bucket, seconds):
        """One inference-plane batch: ``n_real`` rows padded to
        ``bucket``."""
        with self._lock:
            self.batches_total += 1
            self.batch_rows_total += int(n_real)
            self.batch_slots_total += int(bucket)
            self.batch_time.add(seconds)

    def observe_response(self, latency_s):
        with self._lock:
            self.responses_total += 1
            self.latency.add(latency_s)

    def observe_error(self, n=1):
        with self._lock:
            self.errors_total += int(n)

    def observe_ttft(self, seconds):
        with self._lock:
            self.ttft.add(seconds)

    def observe_decode_step(self, n_active, n_slots, seconds,
                            prefill_lanes=0, accepted_tokens=0,
                            drafted_tokens=0, spec_slots=0):
        """One slab step: n_active of n_slots held live requests;
        prefill_lanes = teacher-forced lanes fed beyond each slot's own
        token.  A speculating engine adds drafted_tokens (draft lanes
        the step scored), accepted_tokens (lanes the target matched) and
        spec_slots (slots that speculated)."""
        with self._lock:
            self.decode_steps_total += 1
            self.active_slot_steps_total += int(n_active)
            self.slot_count = int(n_slots)
            self.prefill_lane_steps_total += int(prefill_lanes)
            self.drafted_tokens_total += int(drafted_tokens)
            self.accepted_tokens_total += int(accepted_tokens)
            if spec_slots:
                self.spec_steps_total += 1
                self.spec_slot_steps_total += int(spec_slots)
            self.tpot.add(seconds)

    def observe_prefill_chunk(self, lanes):
        with self._lock:
            self.prefill_chunks_total += 1
            self.prefill_chunk_lanes_total += int(lanes)

    def set_prefill_chunk(self, k):
        with self._lock:
            self.prefill_chunk_size = int(k)

    def set_speculate_k(self, k):
        """Gauge: the engine's draft lanes a slot (0 = speculation
        off)."""
        with self._lock:
            self.speculate_k = int(k)

    def observe_gen_tokens(self, n=1):
        with self._lock:
            self.gen_tokens_total += int(n)

    def evict_slot(self, reason):
        with self._lock:
            self.evictions[reason] = self.evictions.get(reason, 0) + 1

    def observe_prefix_cache(self, hit):
        """One fresh admission's prefix-cache outcome: seated from
        resident blocks (hit) or prefilled (miss)."""
        with self._lock:
            if hit:
                self.prefix_cache_hits += 1
            else:
                self.prefix_cache_misses += 1

    def observe_cow_fork(self, n=1):
        with self._lock:
            self.cow_forks += int(n)

    def set_kv_pool(self, free, total):
        """Snapshot the block pool's free/allocatable gauges."""
        with self._lock:
            self.kv_blocks_free = int(free)
            self.kv_blocks_total = int(total)

    def set_kv_dtype(self, kv_dtype):
        """Gauge: the engine's KV-cache storage dtype ("int8" ->
        ``kv_cache_int8 1`` on /metrics)."""
        with self._lock:
            self.kv_dtype = str(kv_dtype)

    def observe_slot_reprefill(self, n=1):
        with self._lock:
            self.slot_reprefills_total += int(n)

    def observe_kv_spill(self, blocks):
        """One prefix chain spilled to the host tier at eviction."""
        with self._lock:
            self.kv_spill_blocks_total += int(blocks)

    def observe_kv_restore(self, nbytes, seconds):
        """One spilled chain restored and committed (``seconds`` = the
        job's submit-to-commit wall time)."""
        with self._lock:
            self.kv_restore_hits_total += 1
            self.kv_restore_bytes_total += int(nbytes)
            self.kv_restore.add(seconds)

    def set_host_tier_bytes(self, nbytes):
        """Gauge: serialized payload bytes resident in the host tier."""
        with self._lock:
            self.host_tier_bytes = int(nbytes)

    def observe_kv_handoff(self, outcome, nbytes=0, seconds=None):
        """One cross-replica KV handoff event: ``outcome`` in
        ``HANDOFF_OUTCOMES``, ``nbytes`` the blob's bytes, ``seconds`` the
        receive side's decide-to-deliver wall time."""
        with self._lock:
            self.kv_handoffs[outcome] += 1
            self.kv_handoff_bytes_total += int(nbytes)
            if seconds is not None:
                self.kv_handoff.add(seconds)

    def observe_retry(self, n=1):
        with self._lock:
            self.retries_total += int(n)

    def observe_watchdog_trip(self):
        with self._lock:
            self.watchdog_trips_total += 1

    def set_breaker_state(self, state, opened_total=None):
        """Snapshot the breaker's state ('closed' / 'half_open' / 'open')
        and its cumulative open count."""
        with self._lock:
            self.breaker_state = BREAKER_STATES.get(state, 0)
            if opened_total is not None:
                self.breaker_open_total = int(opened_total)

    # ------------------------------------------------------------ derive

    @property
    def mean_occupancy(self):
        """Real rows per executed inference batch (> 1.0 iff batching
        happened)."""
        with self._lock:
            return (self.batch_rows_total / self.batches_total
                    if self.batches_total else 0.0)

    @property
    def padding_waste(self):
        """Fraction of executed bucket slots that held padding."""
        with self._lock:
            return (1.0 - self.batch_rows_total / self.batch_slots_total
                    if self.batch_slots_total else 0.0)

    @property
    def mean_slot_occupancy(self):
        """Active slots per decode step."""
        with self._lock:
            return (self.active_slot_steps_total / self.decode_steps_total
                    if self.decode_steps_total else 0.0)

    @property
    def mean_prefill_chunk_occupancy(self):
        """Fraction of the per-step chunk-lane capacity (slots * (K - 1)
        teacher-forced lanes) actually fed."""
        with self._lock:
            cap = (self.decode_steps_total * self.slot_count
                   * max(0, self.prefill_chunk_size - 1))
            return (self.prefill_lane_steps_total / cap) if cap else 0.0

    @property
    def spec_acceptance_rate(self):
        """Fraction of drafted lanes the target accepted (0.0 with no
        drafts scored)."""
        with self._lock:
            return (self.accepted_tokens_total / self.drafted_tokens_total
                    if self.drafted_tokens_total else 0.0)

    @property
    def spec_tokens_per_step(self):
        """Mean emitted tokens per speculating slot-step: each verify
        span emits its accepted run plus the target's own token, so this
        is >= 1.0 whenever speculation ran; 0.0 without speculation."""
        with self._lock:
            return ((self.accepted_tokens_total + self.spec_slot_steps_total)
                    / self.spec_slot_steps_total
                    if self.spec_slot_steps_total else 0.0)

    def queue_depth(self):
        return sum(int(fn()) for fn in list(self.queue_depth_fns))

    def _percentiles_ms(self, hist):
        with self._lock:
            pct = hist.percentiles(_QUANTILES)
        return {f"p{q}": v * 1e3 for q, v in pct.items()}

    def snapshot(self):
        """All metrics as one dict."""
        with self._lock:
            out = {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "errors_total": self.errors_total,
                "rejected": dict(self.rejected),
                "gen_tokens_total": self.gen_tokens_total,
                "decode_steps_total": self.decode_steps_total,
                "slot_count": self.slot_count,
                "prefill_chunks_total": self.prefill_chunks_total,
                "prefill_chunk_lanes_total": self.prefill_chunk_lanes_total,
                "prefill_chunk_size": self.prefill_chunk_size,
                "evictions": dict(self.evictions),
                "kv_blocks_total": self.kv_blocks_total,
                "kv_blocks_free": self.kv_blocks_free,
                "kv_dtype": self.kv_dtype,
                "kv_blocks_used": self.kv_blocks_total
                - self.kv_blocks_free,
                "kv_block_utilization": round(
                    (self.kv_blocks_total - self.kv_blocks_free)
                    / self.kv_blocks_total, 3) if self.kv_blocks_total
                else 0.0,
                "prefix_cache_hits_total": self.prefix_cache_hits,
                "prefix_cache_misses_total": self.prefix_cache_misses,
                "cow_forks_total": self.cow_forks,
                "slot_reprefills_total": self.slot_reprefills_total,
                "batches_total": self.batches_total,
                "batch_rows_total": self.batch_rows_total,
                "batch_slots_total": self.batch_slots_total,
                "kv_spill_blocks_total": self.kv_spill_blocks_total,
                "kv_restore_hits_total": self.kv_restore_hits_total,
                "kv_restore_bytes_total": self.kv_restore_bytes_total,
                "host_tier_bytes": self.host_tier_bytes,
                "kv_handoffs_total": dict(self.kv_handoffs),
                "kv_handoff_bytes_total": self.kv_handoff_bytes_total,
                "retries_total": self.retries_total,
                "watchdog_trips_total": self.watchdog_trips_total,
                "breaker_open_total": self.breaker_open_total,
                "breaker_state": self.breaker_state,
                "speculate_k": self.speculate_k,
                "drafted_tokens_total": self.drafted_tokens_total,
                "accepted_tokens_total": self.accepted_tokens_total,
                "spec_steps_total": self.spec_steps_total,
                "spec_slot_steps_total": self.spec_slot_steps_total,
            }
        out["faults_fired"] = faults.fired_counts()
        out["queue_depth"] = self.queue_depth()
        out["mean_occupancy"] = round(self.mean_occupancy, 3)
        out["padding_waste"] = round(self.padding_waste, 3)
        out["mean_slot_occupancy"] = self.mean_slot_occupancy
        out["mean_prefill_chunk_occupancy"] = \
            self.mean_prefill_chunk_occupancy
        out["spec_acceptance_rate"] = round(self.spec_acceptance_rate, 4)
        out["spec_tokens_per_step"] = round(self.spec_tokens_per_step, 4)
        out["latency_ms"] = self._percentiles_ms(self.latency)
        out["ttft_ms"] = self._percentiles_ms(self.ttft)
        out["tpot_ms"] = self._percentiles_ms(self.tpot)
        out["batch_time_ms"] = self._percentiles_ms(self.batch_time)
        out["kv_restore_ms"] = self._percentiles_ms(self.kv_restore)
        out["kv_handoff_ms"] = self._percentiles_ms(self.kv_handoff)
        return out

    # ------------------------------------------------------------ render

    def render_prometheus(self):
        """Prometheus text exposition for the /metrics endpoint."""
        n = self.name
        snap = self.snapshot()
        lines = []

        def emit(metric, value, help_, mtype="gauge"):
            lines.append(f"# HELP {n}_{metric} {help_}")
            lines.append(f"# TYPE {n}_{metric} {mtype}")
            lines.append(f"{n}_{metric} {value}")

        for metric, help_ in (
                ("requests_total", "requests accepted into the queue"),
                ("responses_total", "requests answered with a result"),
                ("errors_total", "requests failed by a step error"),
                ("gen_tokens_total", "generated tokens delivered"),
                ("decode_steps_total", "slab decode steps executed"),
                ("prefill_chunks_total",
                 "prompt chunks fed through the decode step"),
                ("prefill_chunk_lanes_total",
                 "teacher-forced chunk lanes fed through the decode step"),
                ("prefix_cache_hits_total",
                 "fresh admissions seated from resident prefix blocks "
                 "(paged KV cache)"),
                ("prefix_cache_misses_total",
                 "fresh admissions that prefilled (paged KV cache)"),
                ("cow_forks_total",
                 "copy-on-write KV block forks (paged KV cache)"),
                ("slot_reprefills_total",
                 "decode slots re-seated (pool preemption or recovery)"),
                ("batches_total", "inference-plane batches executed"),
                ("batch_rows_total", "real request rows executed"),
                ("batch_slots_total",
                 "bucket slots executed (rows + padding)"),
                ("kv_spill_blocks_total",
                 "KV blocks serialized to the host tier at prefix "
                 "eviction"),
                ("kv_restore_hits_total",
                 "spilled prefix chains restored from the host tier"),
                ("kv_restore_bytes_total",
                 "serialized payload bytes restored host to device"),
                ("kv_handoff_bytes_total",
                 "KV blob bytes crossing the cross-replica handoff, sent "
                 "+ received"),
                ("retries_total",
                 "transient submit failures absorbed by bounded retry"),
                ("watchdog_trips_total",
                 "decode steps abandoned past the watchdog deadline"),
                ("breaker_open_total",
                 "times the circuit breaker tripped open"),
                ("drafted_tokens_total",
                 "draft lanes scored by verify steps (speculative "
                 "decoding)"),
                ("accepted_tokens_total",
                 "draft lanes the target accepted (speculative decoding)"),
                ("spec_steps_total",
                 "decode steps that verified at least one draft span"),
                ("spec_slot_steps_total",
                 "per-slot verify spans scored (speculating slots summed "
                 "over steps)")):
            emit(metric, snap[metric], help_, mtype="counter")
        for label, counts, help_ in (
                ("rejected_total", snap["rejected"],
                 "requests rejected before the queue, by reason"),
                ("slot_evictions_total", snap["evictions"],
                 "decode slots evicted, by reason"),
                ("kv_handoffs_total", snap["kv_handoffs_total"],
                 "cross-replica KV handoffs, by outcome")):
            lines.append(f"# HELP {n}_{label} {help_}")
            lines.append(f"# TYPE {n}_{label} counter")
            key = "outcome" if label == "kv_handoffs_total" else "reason"
            for reason in sorted(counts):
                lines.append(f'{n}_{label}{{{key}="{reason}"}} '
                             f"{counts[reason]}")
        emit("queue_depth", snap["queue_depth"], "requests waiting in queue")
        emit("batch_occupancy_mean", f"{self.mean_occupancy:.6f}",
             "mean real rows per executed batch")
        emit("padding_waste_ratio", f"{self.padding_waste:.6f}",
             "fraction of executed slots that held padding")
        emit("host_tier_bytes", snap["host_tier_bytes"],
             "serialized KV payload bytes resident in the host spill tier "
             "(0 = tier off)")
        emit("breaker_state", snap["breaker_state"],
             "circuit breaker state (0 closed, 1 half-open, 2 open)")
        emit("slot_count", snap["slot_count"], "decode slots in the slab")
        emit("slot_occupancy_mean", f"{snap['mean_slot_occupancy']:.6f}",
             "mean active slots per decode step")
        emit("prefill_chunk_size", snap["prefill_chunk_size"],
             "chunked-prefill lanes per step (K; 0 = legacy ladder)")
        emit("prefill_chunk_occupancy_mean",
             f"{snap['mean_prefill_chunk_occupancy']:.6f}",
             "fraction of per-step chunk-lane capacity fed")
        emit("speculate_k", snap["speculate_k"],
             "draft lanes per slot per verify step (0 = speculation off)")
        emit("spec_acceptance_rate", f"{self.spec_acceptance_rate:.6f}",
             "fraction of drafted lanes the target accepted")
        emit("spec_tokens_per_step", f"{self.spec_tokens_per_step:.6f}",
             "mean emitted tokens per speculating slot-step (>= 1 when "
             "speculation runs)")
        emit("kv_blocks_total", snap["kv_blocks_total"],
             "allocatable KV blocks in the paged pool (0 = slab layout)")
        emit("kv_blocks_free", snap["kv_blocks_free"],
             "free KV blocks in the paged pool")
        emit("kv_blocks_used", snap["kv_blocks_used"],
             "KV blocks held by slot chains / the prefix index")
        emit("kv_block_utilization", f"{snap['kv_block_utilization']:.6f}",
             "fraction of the paged KV pool in use")
        emit("kv_cache_int8", int(snap["kv_dtype"] == "int8"),
             "1 when the KV cache stores int8 codes + per-head scale "
             "sidecars (quantized serving)")
        for hist, metric, help_ in (
                (self.latency, "latency_seconds",
                 "request wall latency (submit to response)"),
                (self.ttft, "ttft_seconds",
                 "time to first token (submit to first token)"),
                (self.tpot, "tpot_seconds",
                 "per-output-token latency (one slab decode step)"),
                (self.batch_time, "batch_time_seconds",
                 "engine batch execution time"),
                (self.kv_restore, "kv_restore_seconds",
                 "host-tier restore submit-to-commit wall time"),
                (self.kv_handoff, "kv_handoff_seconds",
                 "receive-side handoff decide-to-deliver wall time")):
            with self._lock:
                pct, count = hist.percentiles(_QUANTILES), hist.count
            lines.append(f"# HELP {n}_{metric} {help_}, recent-window "
                         "quantiles")
            lines.append(f"# TYPE {n}_{metric} summary")
            for q, v in pct.items():
                lines.append(f'{n}_{metric}{{quantile="0.{q}"}} {v:.6f}')
            lines.append(f"{n}_{metric}_count {count}")
        fired = faults.fired_counts()
        lines.append(f"# HELP {n}_fault_injections_total injected faults "
                     "fired, by point (resilience/faults.py)")
        lines.append(f"# TYPE {n}_fault_injections_total counter")
        for point in sorted(fired):
            lines.append(f'{n}_fault_injections_total{{point="{point}"}} '
                         f"{fired[point]}")
        return "\n".join(lines) + "\n"
