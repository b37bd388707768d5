"""The hierarchical-KV and handoff cost model
(``paddle_tpu/perf/analytic.py:508-595``): first-principles wall costs
the serving engine compares before it restores a spilled prefix from the
host tier, or fetches one from a peer replica, instead of recomputing it
through the chunked step.  Each takes a ``chip`` (a ``roofline.SPECS``
key or a ``ChipSpec``); the dispatch floor is the row's
``step_dispatch_ms``."""

from paddle_tpu_torch.perf import roofline
from paddle_tpu_torch.quant import kv as kvq

# Scheduling cycles a host-tier restore spends off the device: the
# admission pass that claims and defers, the transfer landing between two
# steps, and the commit-and-reseat pass — priced at the dispatch floor.
RESTORE_CYCLES = 3
# JAX's per-step dispatch floor (ms), the ``cpu`` row's value
STEP_DISPATCH_MS = 0.05
# Effective socket bandwidth of a cross-replica handoff blob (JAX's
# conservative datacenter 25GbE goodput floor; loopback is faster), so
# the handoff router errs toward recompute
HANDOFF_LINK_BYTES_PER_S = 3e9
# cycles a handoff spends beyond a restore's: the export waiting for its
# between-steps seam, and the HTTP request leg
HANDOFF_CYCLES = RESTORE_CYCLES + 2


def _spec(chip):
    return roofline.SPECS[chip] if isinstance(chip, str) else chip


def _payload(covered, layers, dkv, kv_heads, kv_dtype):
    return float(covered) * int(layers) \
        * kvq.kv_bytes_per_position(dkv, kv_heads, kv_dtype)


def predicted_restore_ms(covered, layers, dkv, kv_heads,
                         kv_dtype="float32", chip="cpu"):
    """Wall cost of restoring a ``covered``-position spilled chain: its
    serialized payload (int8 codes plus f32 scales on a quantized cache,
    times ``layers``) streamed once over the host link, plus
    ``RESTORE_CYCLES`` dispatch floors."""
    spec = _spec(chip)
    return RESTORE_CYCLES * spec.step_dispatch_ms \
        + _payload(covered, layers, dkv, kv_heads, kv_dtype) \
        / spec.host_link_bytes_per_s * 1e3


def predicted_handoff_ms(covered, layers, dkv, kv_heads,
                         kv_dtype="float32", chip="cpu"):
    """Wall cost of handing a ``covered``-position chain off from a peer:
    the same payload over the handoff socket AND the receiver's host
    link, plus ``HANDOFF_CYCLES`` dispatch floors."""
    spec = _spec(chip)
    payload = _payload(covered, layers, dkv, kv_heads, kv_dtype)
    return HANDOFF_CYCLES * spec.step_dispatch_ms \
        + payload / HANDOFF_LINK_BYTES_PER_S * 1e3 \
        + payload / spec.host_link_bytes_per_s * 1e3


def predicted_recompute_ms(covered, param_count, param_bytes,
                           prefill_chunk, chip="cpu"):
    """Wall cost of recomputing a ``covered``-position prefix through the
    chunked step: ``ceil(covered / (K - 1))`` steps, each streaming the
    trunk's stored weight bytes, together ``2 * covered * param_count``
    FLOPs, priced by the roofline plus a dispatch floor a step."""
    spec = _spec(chip)
    lanes = max(1, int(prefill_chunk) - 1)
    steps = -(-int(covered) // lanes)
    r = roofline.predict(2.0 * float(covered) * float(param_count),
                         float(steps) * float(param_bytes), spec)
    return steps * spec.step_dispatch_ms + r["predicted_ms"]
