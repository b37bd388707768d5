"""Live generation-serving metrics — the parts of ``paddle_tpu/serving/
metrics.py::ServingMetrics`` that the port's engine, batcher and
``/metrics`` use: request/response/rejection counters, TTFT, per-step
time (TPOT), slot occupancy, chunked-prefill lanes, slot evictions, the
paged KV pool's gauges and prefix-sharing counters, the KV cache's
storage dtype, speculative decoding's draft lanes and acceptance, and
the injected faults fired by point (``fault_injections_total``,
``resilience/faults.fired_counts``).

One instance is shared by the engine, the batcher and the HTTP front-end.
``render_prometheus()`` is the ``/metrics`` text; ``snapshot()`` the same
data as a dict."""

import threading

from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.utils.stats import Histogram

# submit() rejection reasons — keys are part of the /metrics surface
REJECT_REASONS = ("overload", "deadline", "invalid", "shutdown")

# decode-slot eviction reasons: eos = the model emitted the stop token,
# length = max_tokens reached, error = the slot's request failed with its
# step, shutdown = close(drain=False), abandoned = the caller went away,
# pool_exhausted = the paged KV pool ran dry and the slot was preempted
# (its request re-seats and continues)
EVICT_REASONS = ("eos", "length", "error", "shutdown", "abandoned",
                 "pool_exhausted")

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
        self.slot_reprefills_total = 0   # preempted slots re-seated
        # each batcher contributes a zero-arg callable -> its queue depth
        self.queue_depth_fns = []

    # ------------------------------------------------------------ record

    def accepted(self):
        with self._lock:
            self.requests_total += 1

    def reject(self, reason):
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

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

    # ------------------------------------------------------------ derive

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
                "speculate_k": self.speculate_k,
                "drafted_tokens_total": self.drafted_tokens_total,
                "accepted_tokens_total": self.accepted_tokens_total,
                "spec_steps_total": self.spec_steps_total,
                "spec_slot_steps_total": self.spec_slot_steps_total,
            }
        out["faults_fired"] = faults.fired_counts()
        out["queue_depth"] = self.queue_depth()
        out["mean_slot_occupancy"] = self.mean_slot_occupancy
        out["mean_prefill_chunk_occupancy"] = \
            self.mean_prefill_chunk_occupancy
        out["spec_acceptance_rate"] = round(self.spec_acceptance_rate, 4)
        out["spec_tokens_per_step"] = round(self.spec_tokens_per_step, 4)
        out["latency_ms"] = self._percentiles_ms(self.latency)
        out["ttft_ms"] = self._percentiles_ms(self.ttft)
        out["tpot_ms"] = self._percentiles_ms(self.tpot)
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
                 "preempted decode slots re-seated"),
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
                 "decode slots evicted, by reason")):
            lines.append(f"# HELP {n}_{label} {help_}")
            lines.append(f"# TYPE {n}_{label} counter")
            for reason in sorted(counts):
                lines.append(f'{n}_{label}{{reason="{reason}"}} '
                             f"{counts[reason]}")
        emit("queue_depth", snap["queue_depth"], "requests waiting in queue")
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
                 "per-output-token latency (one slab decode step)")):
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
