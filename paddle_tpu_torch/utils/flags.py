"""Global runtime flags (``paddle_tpu/utils/flags.py``, copied JAX-free).

The reference's gflags surface (paddle/utils/Flags.cpp:18-110 and the
trainer's DEFINE_* in trainer/Trainer.cpp / TrainerMain.cpp, documented
under doc/howto/usage/cmd_parameter).  Every reference flag is either
carried over under its own name, renamed to its equivalent, or listed in
``SUBSUMED`` with the mechanism that replaces it.

The field set is JAX's, less the fields whose only meaning is JAX's
runtime (``JAX_ONLY``, each with its reason), plus the reference's own
``use_gpu`` in place of JAX's ``use_tpu``.  Defaults are JAX's except
where ``PORT_DEFAULTS`` says why not: ``compute_dtype`` defaults to the
port's auto policy (float32; ``core/dtypes.py``), so ``apply()`` never
switches the card to bf16 unasked.  The port's kernels dispatch by the
device of the tensors they are given, with no mode flag, so no field
here switches a kernel.
"""


import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class Flags:
    # ---- device / precision (reference: use_gpu, gpu_id, trainer_count)
    use_gpu: bool = True            # the reference's flag; False pins the
    #                                 CPU for entry points given no device
    dtype: str = "float32"          # parameter dtype ("real" in the reference)
    compute_dtype: str = "auto"     # matmul/conv compute dtype; auto =
    #                                 float32 (the port's auto policy)
    seed: int = 1                   # reference: --seed (0 = time-based)

    # ---- jobs / config (reference: job, config, config_args)
    job: str = "train"              # train | test | checkgrad | merge_model
    config: Optional[str] = None
    config_args: str = ""
    comment: str = ""               # freeform run annotation, logged once

    # ---- training loop (reference names kept)
    log_period: int = 100
    dot_period: int = 1             # reference --dot_period ('.' cadence);
    #                                 kept for config compat, logging is the
    #                                 real progress channel here
    saving_period: int = 1
    saving_period_by_batches: int = 0   # 0 = off (save per pass only)
    test_period: int = 0
    test_pass: Optional[int] = None
    average_test_period: int = 0    # Polyak-averaged eval cadence
    num_passes: int = 1
    start_pass: int = 0
    save_dir: Optional[str] = None
    save_only_one: bool = False
    init_model_path: Optional[str] = None
    load_missing_parameter_strategy: str = "fail"  # fail | rand | zero
    show_parameter_stats_period: int = 0
    show_layer_stat: bool = False   # per-layer output stats each log_period
    checkgrad_eps: float = 1e-3
    prev_batch_state: bool = False  # carry RNN state across batches
    with_cost: bool = True

    # ---- prediction outputs (reference: predict_file, predict_output_dir)
    predict_file: Optional[str] = None
    predict_output_dir: Optional[str] = None

    # ---- parallelism: mesh shape replaces trainer_count/ports/pserver
    # topology (reference: trainer_count, parallel_nn, num_gradient_servers)
    data_parallel: int = 0   # 0 = all devices
    model_parallel: int = 1
    seq_parallel: int = 1
    expert_parallel: int = 1
    # multi-host rendezvous (reference: port/ports_num/nics/trainer_id ->
    # one coordinator address + process indices, parallel/distributed.py)
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    dcn_data_parallel: int = 1      # slices joined over DCN (hybrid mesh)

    # ---- decoding
    beam_size: int = 1

    # ---- data
    async_load_data: bool = True    # reference DoubleBuffer on/off; with
    #                                 prefetch_depth, the CLI default for
    #                                 --prefetch (SGD.train(prefetch=N),
    #                                 data/prefetch.py device pipeline)
    prefetch_depth: int = 2

    # ---- serving runtime (serving/: dynamic batcher + HTTP front-end;
    # the reference served through C++ services over the C API with no
    # batching layer, so these are TPU-native)
    serving_port: int = 8080
    serving_buckets: str = "1,4,16,64"
    serving_max_batch_size: int = 0     # 0 = the bucket ladder's top
    serving_max_delay_ms: float = 5.0
    serving_queue_size: int = 256
    serving_deadline_ms: float = 0.0    # 0 = no per-request deadline
    # ---- generation serving (serving/decode_engine.py: slot-based
    # continuous batching over a fixed KV-cache slab; docs/serving.md §4)
    serving_gen_slots: int = 8          # concurrent decode slots
    serving_gen_max_len: int = 256      # KV slab length (prompt + output)
    serving_gen_prefill_buckets: str = "32,64"  # prompt-length ladder
    serving_gen_max_tokens: int = 64    # default per-request emission cap
    # ---- paged KV cache (serving/kv_pool.py: block-pool allocator +
    # copy-on-write prefix sharing; docs/serving.md §5)
    serving_kv_layout: str = "slab"     # "slab" | "paged"
    serving_kv_block_size: int = 16     # KV positions per paged block
    serving_kv_num_blocks: int = 0      # pool size incl. scratch block
    #                                     (0 = slab-equivalent bytes)
    serving_kv_prefix_cache: bool = True  # share resident prompt-prefix
    #                                       blocks across requests
    serving_kv_host_bytes: int = 0      # host-RAM spill-tier cap, bytes
    #                                     (hierarchical KV: evicted
    #                                     prefix chains spill and
    #                                     restore instead of
    #                                     recomputing; 0 = tier off)
    # ---- disaggregated serving (serving/transfer.py: cross-replica
    # KV-block handoff over a socket transport; docs/serving.md
    # "Disaggregated serving")
    serving_role: str = "mixed"         # replica role in a disaggregated
    #                                     fleet: "prefill" | "decode" |
    #                                     "mixed"
    serving_handoff: bool = True        # router: hand streams off from
    #                                     the prefill pool to the decode
    #                                     pool at first token (active
    #                                     only when both roles exist)
    serving_handoff_max_bytes: int = 256 << 20  # receive-side bound on
    #                                     ONE handoff blob's bytes (a
    #                                     garbled peer must never OOM
    #                                     the receiver)
    serving_handoff_timeout_s: float = 5.0  # socket timeout for one
    #                                     export fetch (expired =
    #                                     recompute fallback)
    # ---- quantized serving (paddle_tpu/quant/: int8 weights + int8 KV
    # cache with in-register dequant in the fused decode kernels;
    # docs/serving.md "Quantized serving")
    serving_kv_dtype: str = "float32"   # "float32" | "int8" (quantized
    #                                     KV + per-head scale sidecars;
    #                                     paged auto-sizing doubles the
    #                                     block count at equal bytes)
    quant_weights: bool = False         # serve per-channel int8 trunk
    #                                     weights (quant/weights.py)
    quant_train: bool = False           # int8 weight-streaming train
    #                                     step (trainer quant_weights
    #                                     mode: f32 masters optimizer-
    #                                     side, requantize after update)
    # ---- unified chunked prefill (decode_engine.py prefill_chunk:
    # prompt ingestion folded into the ONE jitted decode step as K-lane
    # chunks; docs/serving.md "Chunked prefill").  The serving CLI
    # defaults to chunked; 0 demotes to the legacy per-bucket prefill
    # ladder.
    serving_prefill_chunk: int = 8      # lanes per chunked-prefill step
    #                                     (K; 0 = legacy ladder prefill)
    serving_prefill_chunk_budget: int = 0  # max teacher-forced lanes per
    #                                        step across all slots
    #                                        (0 = unbounded); data, not
    #                                        shape — tuning never
    #                                        retraces
    # ---- speculative decoding (serving/speculative.py: a truncated-
    # trunk draft proposes k tokens per slot, the one chunked step
    # scores every lane; docs/serving.md "Speculative decoding")
    serving_speculate_k: int = 0        # draft tokens per slot per step
    #                                     (k; 0 = speculation off —
    #                                     requires chunked prefill)
    serving_draft_layers: int = 1       # trunk depth of the derived
    #                                     draft (make_draft: first N enc
    #                                     blocks, embedding shared)
    # ---- tensor-parallel sharded decode (parallel/sharding.py +
    # decode_engine mesh=; docs/serving.md "Sharded decode")
    serving_mesh_shards: int = 1        # model-axis mesh size the ONE
    #                                     chunked step spans (heads/KV/
    #                                     vocab striped, streams bit-
    #                                     identical); 0/1 = single-chip
    # ---- replicated serving tier (serving/fleet.py supervisor +
    # serving/router.py health-checked router; docs/serving.md §7)
    router_port: int = 8000             # HTTP port for the router CLI
    router_poll_interval_s: float = 0.25  # /readyz + /metrics poll cadence
    router_unready_grace_s: float = 2.0  # on an all-unready pick miss,
    #                                     probe + wait this long before
    #                                     failing the request (covers the
    #                                     poller's view lag of a freshly
    #                                     restarted replica)
    router_eject_threshold: int = 3     # consecutive dispatch failures
    #                                     that eject a replica (outlier
    #                                     ejection, breaker-style)
    router_eject_cooldown_s: float = 2.0  # ejected -> half-open probe
    router_retry_budget: int = 2        # cross-replica retries/failovers
    router_hedge_ms: float = 0.0        # hedged /v1/infer: 0 off, >0 a
    #                                     fixed delay, <0 p99-derived
    fleet_replicas: int = 2             # replicas the supervisor spawns
    fleet_backoff_base_s: float = 0.5   # crash-restart backoff base
    fleet_backoff_max_s: float = 10.0   # crash-restart backoff cap
    fleet_storm_threshold: int = 5      # crashes within the window that
    #                                     trip the restart-storm breaker
    fleet_storm_window_s: float = 30.0  # the restart-storm window
    # ---- adaptive overload control (serving/overload.py wired into
    # router.py: AIMD concurrency limit, priority shedding, brownout
    # ladder; docs/serving.md §8)
    overload_limit_initial: float = 64.0   # AIMD limit starting point
    overload_limit_min: float = 4.0        # multiplicative-decrease floor
    overload_limit_max: float = 4096.0     # additive-increase ceiling
    overload_aimd_increase: float = 1.0    # +increase/limit per completion
    overload_aimd_decrease: float = 0.5    # limit *= decrease on overload
    overload_slo_ttft_ms: float = 0.0      # brownout SLO target (0 = the
    #                                        ladder is disabled)
    overload_window_s: float = 30.0        # recent window for the SLO
    #                                        p99 + the drain-rate estimate
    overload_brownout_hold_s: float = 3.0  # sustained breach before a
    #                                        rung is entered
    overload_brownout_exit_s: float = 5.0  # sustained health before a
    #                                        rung is exited
    overload_brownout_max_tokens: int = 32  # rung-2 per-request token cap
    # ---- autoscaler (serving/autoscaler.py: trace-driven control loop
    # over the replica fleet; docs/serving.md §8)
    autoscaler_poll_interval_s: float = 1.0  # metrics poll cadence
    autoscaler_target_ttft_ms: float = 500.0  # the SLO the loop tracks
    autoscaler_hysteresis: float = 0.2  # dead band around the target:
    #                                     out above target*(1+h), in below
    #                                     target*(1-h) only
    autoscaler_breach_polls: int = 3    # consecutive breach polls before
    #                                     a scale-out fires
    autoscaler_slack_polls: int = 6     # consecutive slack polls before
    #                                     a scale-in fires
    autoscaler_cooldown_out_s: float = 10.0  # min gap after ANY scale
    #                                          before an out fires
    autoscaler_cooldown_in_s: float = 60.0   # min gap after ANY scale
    #                                          before an in fires
    autoscaler_min_replicas: int = 1
    autoscaler_max_replicas: int = 4
    autoscaler_window_s: float = 30.0   # recent window for the SLO p99
    autoscaler_seed: int = 0            # poll jitter + backoff streams
    # ---- resilience (resilience/: deterministic fault injection +
    # supervised recovery; docs/serving.md §6)
    serving_drain_timeout_s: float = 30.0  # SIGTERM drain hard deadline
    resilience_fault_spec: str = ""     # chaos-only fault plan, e.g.
    #                                     "serving.decode_step:at=5"
    resilience_step_deadline_ms: float = 0.0  # decode watchdog (0 = off)
    resilience_breaker_threshold: int = 5     # consecutive failures -> open
    resilience_breaker_cooldown_s: float = 5.0  # open -> half-open probe
    resilience_retry_budget: int = 3    # transient submit retries

    # ---- static invariant analyzer (paddle_tpu/analysis/: jit-purity,
    # retrace-hazard and lock-order passes gated on every commit;
    # docs/analysis.md)
    analysis_baseline: Optional[str] = None  # allow-list path override
    #                                     (None = the committed
    #                                     paddle_tpu/analysis/
    #                                     baseline.json)
    analysis_strict: bool = False       # stale baseline entries (a
    #                                     documented violation that no
    #                                     longer exists) fail the gate
    #                                     instead of warning

    # ---- observability (new floor; reference had host timers only)
    # request tracing (obs/trace.py: host-side span recorder + cross-
    # process propagation + Chrome-trace export; docs/observability.md)
    obs_trace_enable: bool = False      # off in prod-style runs; tests/
    #                                     smokes turn it on explicitly
    obs_trace_sample: float = 1.0       # deterministic head sampling
    #                                     keyed on the trace_id hash
    obs_trace_ring: int = 4096          # completed spans kept (ring)
    profile_dir: Optional[str] = None   # capture an xprof trace of training
    debug_nans: bool = False            # NaN -> immediate error with op
    #                                     location (reference feenableexcept
    #                                     in TrainerMain.cpp:49)
    memory_profile_path: Optional[str] = None  # dump device memory profile

    def update_from_args(self, args):
        for field in dataclasses.fields(self):
            if hasattr(args, field.name) and getattr(args, field.name) is not None:
                setattr(self, field.name, getattr(args, field.name))

    def add_to_parser(self, parser: argparse.ArgumentParser):
        for field in dataclasses.fields(self):
            name = "--" + field.name
            ftype = str(field.type)
            if field.type is bool or isinstance(field.default, bool):
                parser.add_argument(name, type=lambda v: v.lower() in ("1", "true", "yes"),
                                    default=None)
            elif isinstance(field.default, float) or "float" in ftype:
                parser.add_argument(name, type=float, default=None)
            elif isinstance(field.default, int) or "int" in ftype:
                # covers Optional[int] fields whose default is None
                parser.add_argument(name, type=int, default=None)
            else:
                parser.add_argument(name, type=str, default=None)

    def apply(self):
        """Push flag values into the runtime: the dtype policy (auto =
        float32), anomaly detection for ``debug_nans`` (the autograd
        engine raises on the backward op that produced a NaN), the fault
        plan and the tracer."""
        from paddle_tpu_torch.core import dtypes
        dtypes.set_policy(self.dtype,
                          None if self.compute_dtype in (None, "", "auto")
                          else self.compute_dtype)
        if self.debug_nans:
            import torch
            torch.autograd.set_detect_anomaly(True)
        if self.resilience_fault_spec:
            from paddle_tpu_torch.resilience import faults
            faults.install_spec(self.resilience_fault_spec)
        if self.obs_trace_enable:
            from paddle_tpu_torch.obs import trace
            trace.enable(sample=self.obs_trace_sample,
                         capacity=self.obs_trace_ring)


# JAX's fields with no meaning in this package, and why (the field set
# is JAX's less these, plus use_gpu).
JAX_ONLY = {
    "use_tpu": "the TPU backend switch; the reference's own use_gpu "
               "takes its place",
    "jax_compilation_cache_dir": "XLA's persistent compilation cache; "
                                 "the port compiles no XLA programs "
                                 "(its kernels build once per source "
                                 "hash into paddle_tpu_torch/_build)",
    "pallas_decode": "switches JAX's decode steps between Pallas and "
                     "XLA; the port's decode kernels run on every CUDA "
                     "tensor and their plain versions on CPU tensors, "
                     "with no mode to switch",
    "pallas_decode_block_k": "the Pallas slab kernel's VMEM k-tile; the "
                             "CUDA kernel's split length is fixed in its "
                             "source",
    "pallas_prefill": "routes JAX's prefill through the Pallas flash "
                      "kernel; the port's prefill takes its flash kernel "
                      "by device, with no mode to switch",
    "pallas_prefill_quant": "the same switch for the int8 prefill; the "
                            "port routes it by device and by "
                            "transformer.prefill_quant_covers",
}

# Fields whose default is not JAX's, and why.
PORT_DEFAULTS = {
    "compute_dtype": ("auto", "JAX's default bfloat16 is the TPU's MXU "
                              "choice; auto here is the port's float32 "
                              "policy, so apply() keeps the card in "
                              "float32 unless bfloat16 is asked for"),
}


# Per-flag documentation: {field name: (help, reference cmd_parameter
# equivalent or "—" for flags with no reference twin)}.  The
# flag-reference table (`python -m paddle_tpu_torch.utils.flags`) is
# generated from this dict + the dataclass defaults; every field needs
# a row here.
FLAG_DOCS = {
    "use_gpu": ("run entry points given no device on the card; False "
                "pins the CPU", "use_gpu"),
    "dtype": ("parameter dtype", 'real ("paddle float")'),
    "compute_dtype": ("matmul/conv compute dtype; auto = float32 (the "
                      "port's auto policy), bfloat16 = bf16 products "
                      "with a float32 accumulator", "—"),
    "seed": ("RNG seed (0 = time-based)", "seed"),
    "job": ("train | test | checkgrad | merge_model", "job"),
    "config": ("model config script (native get_config() or reference v1 "
               "trainer_config_helpers script)", "config"),
    "config_args": ("k=v,k=v passed into the config script", "config_args"),
    "comment": ("freeform run annotation, logged once", "—"),
    "log_period": ("batches between progress lines (0 = pass end only)",
                   "log_period"),
    "dot_period": ("'.'-cadence kept for config compat; logging is the "
                   "progress channel here", "dot_period"),
    "saving_period": ("passes between checkpoints", "saving_period"),
    "saving_period_by_batches": ("also checkpoint every N batches "
                                 "(0 = off)", "saving_period_by_batches"),
    "test_period": ("passes between test() sweeps (0 = every pass)",
                    "test_period"),
    "test_pass": ("load pass N for a test job", "test_pass"),
    "average_test_period": ("Polyak-averaged eval cadence",
                            "average_test_period"),
    "num_passes": ("passes over the data", "num_passes"),
    "start_pass": ("resume from pass K (loads pass K-1)", "start_pass"),
    "save_dir": ("checkpoint directory", "save_dir"),
    "save_only_one": ("keep only the latest checkpoint", "save_only_one"),
    "init_model_path": ("warm-start parameters from a checkpoint dir",
                        "init_model_path"),
    "load_missing_parameter_strategy": ("fail | rand | zero for params "
                                        "absent from the warm-start",
                                        "load_missing_parameter_strategy"),
    "show_parameter_stats_period": ("batches between per-param absmax/"
                                    "absavg dumps",
                                    "show_parameter_stats_period"),
    "show_layer_stat": ("per-layer output stats each log_period",
                        "show_layer_stat"),
    "checkgrad_eps": ("finite-difference epsilon for the checkgrad job",
                      "checkgrad_eps"),
    "prev_batch_state": ("carry RNN state across batches",
                         "prev_batch_state"),
    "with_cost": ("train with a cost layer (off for inference nets)",
                  "with_cost"),
    "predict_file": ("input file for the predict drivers", "predict_file"),
    "predict_output_dir": ("where predict jobs write outputs",
                           "predict_output_dir"),
    "data_parallel": ("data-parallel mesh axis (0 = all devices)",
                      "trainer_count"),
    "model_parallel": ("tensor-parallel mesh axis (megatron rules)",
                       "parallel_nn"),
    "seq_parallel": ("sequence/context-parallel axis (ring attention)",
                     "—"),
    "expert_parallel": ("expert-parallel mesh axis (MoE)", "—"),
    "coordinator": ("multi-host rendezvous address "
                    "(jax.distributed)", "port/ports_num/nics"),
    "num_processes": ("process count for multi-host rendezvous",
                      "num_gradient_servers"),
    "process_id": ("this host's index in the rendezvous", "trainer_id"),
    "dcn_data_parallel": ("slices joined over DCN (hybrid ICI×DCN mesh)",
                          "—"),
    "beam_size": ("beam width for generation jobs", "beam_size"),
    "async_load_data": ("input pipeline overlap on/off; with "
                        "prefetch_depth gives --prefetch its default",
                        "async_load_data (DoubleBuffer)"),
    "prefetch_depth": ("batches converted + H2D-transferred ahead on the "
                       "prefetch thread", "—"),
    "serving_port": ("HTTP port for python -m paddle_tpu_torch.serving",
                     "—"),
    "serving_buckets": ("batch bucket ladder (comma ints) the serving "
                        "engine AOT-compiles", "—"),
    "serving_max_batch_size": ("largest dynamic batch formed (0 = the "
                               "bucket ladder's top)", "—"),
    "serving_max_delay_ms": ("how long the first queued request waits "
                             "for batch co-riders", "—"),
    "serving_queue_size": ("admission bound; a full queue rejects with "
                           "HTTP 429", "—"),
    "serving_deadline_ms": ("default per-request deadline (0 = none); "
                            "expired requests fail with HTTP 504", "—"),
    "serving_gen_slots": ("decode slots in the continuous-batching KV "
                          "slab (concurrent generations)", "—"),
    "serving_gen_max_len": ("KV-cache slab length; every request needs "
                            "prompt + max_tokens <= this", "—"),
    "serving_gen_prefill_buckets": ("prompt-length ladder (comma ints) "
                                    "the prefill engines AOT-compile; "
                                    "the top bucket caps prompt length",
                                    "—"),
    "serving_gen_max_tokens": ("default per-request emission cap for "
                               "/v1/generate", "—"),
    "serving_kv_layout": ("decode KV-cache layout: slab (max_len "
                          "reserved per slot) or paged (block pool + "
                          "per-slot block tables, prefix sharing)", "—"),
    "serving_kv_block_size": ("KV positions per paged block", "—"),
    "serving_kv_num_blocks": ("paged pool size incl. the reserved "
                              "scratch block (0 = auto: the slab-"
                              "equivalent slots*ceil(max_len/block_size)"
                              "+1)", "—"),
    "serving_kv_prefix_cache": ("share resident prompt-prefix blocks "
                                "across requests (copy-on-write on "
                                "divergence)", "—"),
    "serving_kv_host_bytes": ("host-RAM spill-tier byte cap for the "
                              "hierarchical KV cache: prefix chains "
                              "evicted under pool pressure serialize "
                              "to host buffers and restore "
                              "asynchronously on the next hit when "
                              "perf/analytic predicts restore beats "
                              "recompute (LRU within the cap; 0 = "
                              "tier off; paged + prefix_cache only)",
                              "—"),
    "serving_role": ("replica role in a disaggregated fleet: prefill "
                     "(takes new prompts, exports KV chains), decode "
                     "(receives handoffs, decodes), or mixed (both — "
                     "the single-replica default).  The router routes "
                     "new prompts to the prefill pool and hands "
                     "streams off at first token when both pools "
                     "exist", "—"),
    "serving_handoff": ("router-side switch for cross-replica KV "
                        "handoff: when a prefill pool AND a decode "
                        "pool are both present, new streams prefill "
                        "on one pool and decode on the other, the KV "
                        "chain crossing as a wire-format blob; off = "
                        "roles only affect routing preference and "
                        "every stream recomputes its context on the "
                        "decode replica", "—"),
    "serving_handoff_max_bytes": ("receive-side ceiling on one handoff "
                                  "blob (length prefix AND decoded "
                                  "size are bounded before any "
                                  "allocation); larger exports fall "
                                  "back to recompute", "—"),
    "serving_handoff_timeout_s": ("socket timeout for one KV-export "
                                  "fetch; expiry (e.g. the prefill "
                                  "replica died) falls back to "
                                  "continuation-replay recompute",
                                  "—"),
    "serving_kv_dtype": ("decode KV-cache storage dtype: float32, or "
                         "int8 (quantized K/V + per-(position, head) "
                         "f32 scale sidecars, dequantized in-register "
                         "by the fused decode kernels; the paged "
                         "auto-sizing doubles kv_num_blocks at the "
                         "slab-equivalent byte budget)", "—"),
    "quant_weights": ("serve per-channel symmetric int8 trunk weights "
                      "(quant/weights.py): int8 data + f32 scale "
                      "sidecars are what stays resident; dequant fuses "
                      "into each consuming matmul's operand read", "—"),
    "quant_train": ("int8 weight-streaming training step (trainer "
                    "quant_weights mode): the jitted step is fed the "
                    "{q: int8, s: f32} tree and dequantizes at the "
                    "matmul boundary; f32 master weights live on the "
                    "optimizer side and re-quantize after each update.  "
                    "Checkpoints carry both trees and resume "
                    "bit-identically", "—"),
    "serving_prefill_chunk": ("unified chunked prefill: prompt "
                              "ingestion rides the ONE jitted decode "
                              "step as up-to-K-token chunks per slot "
                              "per step (first token at the last "
                              "chunk); 0 = the legacy per-bucket "
                              "prefill InferenceEngine ladder", "—"),
    "serving_prefill_chunk_budget": ("max teacher-forced chunk lanes "
                                     "one step may feed across all "
                                     "slots (bounds per-step prefill "
                                     "work, hence TPOT jitter; 0 = "
                                     "unbounded).  Fed as data — "
                                     "tuning it never retraces", "—"),
    "serving_speculate_k": ("speculative decoding: a small draft trunk "
                            "proposes k greedy tokens per feeding slot "
                            "and the target's ONE chunked step scores "
                            "every drafted lane at once — each step "
                            "nets 1 + accepted tokens, streams stay "
                            "token-identical to lm_generate (the "
                            "acceptance rule keeps exactly the greedy "
                            "prefix).  0 = off; requires "
                            "serving_prefill_chunk > 0", "—"),
    "serving_mesh_shards": ("tensor-parallel sharded decode: run the "
                            "ONE chunked serving step under an N-chip "
                            "model-axis mesh (decode_mesh) — attention "
                            "heads + the KV pool stripe Hkv/N per chip, "
                            "the embedding stripes vocab/N, wq/wk/wv "
                            "shard their out-feature axis, and the only "
                            "cross-chip seams are the per-layer "
                            "attention-output all-gather, the logits "
                            "all-gather, and the embedding psum.  "
                            "Streams stay BIT-IDENTICAL to the "
                            "single-chip engine; requires "
                            "serving_prefill_chunk > 0 and N dividing "
                            "heads/Hkv/vocab.  0/1 = single-chip", "—"),
    "serving_draft_layers": ("trunk depth of the draft model derived "
                             "from the target (speculative.make_draft: "
                             "the first N enc blocks; embedding / final "
                             "LN / vocab head SHARED with the target, "
                             "so only the truncated trunk adds weight "
                             "bytes)", "—"),
    "router_port": ("HTTP port for python -m paddle_tpu.serving.router",
                    "—"),
    "router_poll_interval_s": ("how often the router polls each "
                               "replica's /readyz + /metrics (readiness "
                               "gating, least-loaded dispatch)", "—"),
    "router_unready_grace_s": ("when no replica looks eligible, the "
                               "router probes /readyz itself and waits "
                               "up to this long before failing the "
                               "request — the health poller's view of "
                               "a freshly restarted replica lags by up "
                               "to a poll interval", "—"),
    "router_eject_threshold": ("consecutive dispatch failures that "
                               "eject a replica from rotation "
                               "(half-open probe readmits)", "—"),
    "router_eject_cooldown_s": ("ejected-replica cooldown before the "
                                "half-open readmission probe", "—"),
    "router_retry_budget": ("bounded cross-replica retries (idempotent "
                            "infer) / mid-stream failovers (generate)",
                            "—"),
    "router_hedge_ms": ("hedged /v1/infer requests: 0 = off, >0 = fire "
                        "the hedge after that fixed delay, <0 = "
                        "p99-derived from recent router latency", "—"),
    "fleet_replicas": ("serving replica subprocesses the fleet "
                       "supervisor spawns", "—"),
    "fleet_backoff_base_s": ("crash-restart exponential-backoff base "
                             "(seeded jitter on top)", "—"),
    "fleet_backoff_max_s": ("crash-restart backoff cap", "—"),
    "fleet_storm_threshold": ("replica crashes within the storm window "
                              "that stop further restarts (restart-"
                              "storm breaker)", "—"),
    "fleet_storm_window_s": ("the restart-storm counting window", "—"),
    "overload_limit_initial": ("router AIMD concurrency limit starting "
                               "point (serving/overload.py)", "—"),
    "overload_limit_min": ("AIMD multiplicative-decrease floor", "—"),
    "overload_limit_max": ("AIMD additive-increase ceiling", "—"),
    "overload_aimd_increase": ("additive increase applied as "
                               "increase/limit per clean completion "
                               "(~ +increase per full window)", "—"),
    "overload_aimd_decrease": ("multiplicative factor on an upstream "
                               "overload signal (replica 429/503), at "
                               "most once per congestion cooldown", "—"),
    "overload_slo_ttft_ms": ("brownout-ladder SLO target on the "
                             "router's recent-window TTFT p99; 0 "
                             "disables the ladder (default)", "—"),
    "overload_window_s": ("recent window for the SLO p99 and the "
                          "drain-rate estimate behind Retry-After", "—"),
    "overload_brownout_hold_s": ("sustained SLO breach before the "
                                 "ladder steps UP one rung", "—"),
    "overload_brownout_exit_s": ("sustained health before the ladder "
                                 "steps DOWN one rung", "—"),
    "overload_brownout_max_tokens": ("per-request max_tokens cap "
                                     "applied at brownout rung 2 "
                                     "(capped streams stay bit-identical "
                                     "prefixes)", "—"),
    "autoscaler_poll_interval_s": ("how often the autoscaler reads the "
                                   "router/replica metrics surface and "
                                   "evaluates the control law", "—"),
    "autoscaler_target_ttft_ms": ("the TTFT p99 target the control "
                                  "loop tracks (serving/autoscaler.py)",
                                  "—"),
    "autoscaler_hysteresis": ("dead band around the target: scale out "
                              "above target*(1+h), scale in below "
                              "target*(1-h) only — flap damping", "—"),
    "autoscaler_breach_polls": ("consecutive breach polls before a "
                                "scale-out fires", "—"),
    "autoscaler_slack_polls": ("consecutive slack polls before a "
                               "scale-in fires", "—"),
    "autoscaler_cooldown_out_s": ("minimum gap after ANY scale action "
                                  "before a scale-out may fire (short: "
                                  "react to load fast)", "—"),
    "autoscaler_cooldown_in_s": ("minimum gap after ANY scale action "
                                 "before a scale-in may fire (long: a "
                                 "scale-in cannot promptly undo a "
                                 "scale-out — flap damping)", "—"),
    "autoscaler_min_replicas": ("fleet size floor the autoscaler may "
                                "never go below", "—"),
    "autoscaler_max_replicas": ("fleet size ceiling the autoscaler may "
                                "never exceed", "—"),
    "autoscaler_window_s": ("recent window for the SLO p99 the control "
                            "law evaluates", "—"),
    "autoscaler_seed": ("seed for the poll-jitter and actuation-retry "
                        "backoff streams (decisions replay bit-for-bit)",
                        "—"),
    "serving_drain_timeout_s": ("hard deadline for the SIGTERM graceful "
                                "drain; a wedged batch can no longer "
                                "hang shutdown (second SIGTERM forces "
                                "exit)", "—"),
    "resilience_fault_spec": ("deterministic fault-injection plan "
                              "(point:at=N/every=K/p=x,seed=S,"
                              "action=error/hang) — chaos testing "
                              "only, strictly no-op when empty", "—"),
    "resilience_step_deadline_ms": ("decode-step watchdog deadline; a "
                                    "hung step is abandoned, the slab "
                                    "rebuilt, slots re-prefilled "
                                    "(0 = off)", "—"),
    "resilience_breaker_threshold": ("consecutive step failures that "
                                     "open the circuit breaker (shed "
                                     "503 + Retry-After)", "—"),
    "resilience_breaker_cooldown_s": ("open-breaker cooldown before the "
                                      "half-open probe", "—"),
    "resilience_retry_budget": ("bounded retries (exp backoff + jitter) "
                                "for transient submit failures", "—"),
    "analysis_baseline": ("static-analyzer allow-list path for `python "
                          "-m paddle_tpu.analysis` (None = the "
                          "committed paddle_tpu/analysis/baseline.json)",
                          "—"),
    "analysis_strict": ("static analyzer: stale baseline entries fail "
                        "the gate (rc 1) instead of warning — keeps the "
                        "allow-list honest in CI", "—"),
    "obs_trace_enable": ("per-request span tracing (obs/trace.py): "
                         "host-side recorder + /debug/traces + Chrome "
                         "export; strictly no-op when off", "—"),
    "obs_trace_sample": ("head-sampling rate, decided deterministically "
                         "from the trace_id hash (every process keeps "
                         "or drops the SAME traces)", "—"),
    "obs_trace_ring": ("completed spans the tracer ring retains "
                       "(oldest overwritten)", "—"),
    "profile_dir": ("capture an xprof/TensorBoard device trace", "—"),
    "debug_nans": ("fail fast on the op producing a NaN",
                   "feenableexcept (TrainerMain.cpp)"),
    "memory_profile_path": ("dump a device memory profile", "—"),
}

_TABLE_BEGIN = ("<!-- BEGIN GENERATED FLAGS TABLE "
                "(python -m paddle_tpu_torch.utils.flags; do not edit) -->")
_TABLE_END = "<!-- END GENERATED FLAGS TABLE -->"


def flags_table_md():
    """The docs/flags.md flag-reference table, generated from the Flags
    dataclass + FLAG_DOCS so the doc can never drift from the code."""
    lines = [_TABLE_BEGIN,
             "",
             "| flag | default | meaning | reference cmd_parameter |",
             "|---|---|---|---|"]
    for field in dataclasses.fields(Flags):
        help_, ref = (s.replace("|", "\\|") for s in FLAG_DOCS[field.name])
        default = "None" if field.default is None else repr(field.default)
        lines.append(f"| `--{field.name}` | `{default}` | {help_} | "
                     f"{ref} |")
    lines += ["", _TABLE_END]
    return "\n".join(lines)


# Reference flags with no runtime role here, and why — the lookup table for
# migrating users (reference Flags.cpp names):
SUBSUMED = {
    "gpu_id": "the card is cuda:0; CUDA_VISIBLE_DEVICES picks it",
    "trainer_count": "data_parallel mesh axis",
    "parallel_nn": "model_parallel mesh axis (sharding rules)",
    "port": "coordinator (jax.distributed rendezvous)",
    "ports_num": "single coordinator address suffices",
    "ports_num_for_sparse": "sparse tables shard over the mesh like any param",
    "nics": "ICI/DCN routing is platform-managed",
    "rdma_tcp": "ICI/DCN routing is platform-managed",
    "trainer_id": "process_id",
    "num_gradient_servers": "num_processes",
    "start_pserver": "no parameter server exists",
    "loadsave_parameters_in_pserver": "checkpoints are sharded pytrees",
    "log_period_server": "no parameter server exists",
    "enable_parallel_vector": "XLA vectorizes",
    "distribute_test": "test() runs under the same mesh",
    "test_all_data_in_one_period": "test() always consumes the full reader",
    "test_wait": "no async pserver to wait for",
    "local": "mesh with one host",
    "model_list / feat_file": "model zoo APIs replace the predict drivers",
}


FLAGS = Flags()


if __name__ == "__main__":
    print(flags_table_md())
