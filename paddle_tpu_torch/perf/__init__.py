"""Analytic performance model of the port (``paddle_tpu/perf``), the
part the serving router reads:

- ``roofline`` — ``ChipSpec`` rows (peak FLOP/s, memory bandwidth, host
  link, the per-step dispatch floor) and ``predict``, the two-ceiling
  roofline;
- ``analytic`` — the hierarchical-KV and handoff cost model:
  ``predicted_restore_ms``, ``predicted_handoff_ms`` and
  ``predicted_recompute_ms``, which ``DecodeEngine`` compares at the spec
  of its device before it restores or fetches a prefix.

The rest of JAX's package (XLA's cost model, the HLO parsers, the bench
snapshot) is ROADMAP A13.
"""

from paddle_tpu_torch.perf import analytic, roofline  # noqa: F401
