"""Roofline model (``paddle_tpu/perf/roofline.py``): (FLOPs, bytes
accessed) -> predicted time, ``t = max(flops / peak_flops, bytes /
hbm_bw)``, and the chip rows the serving router prices its choices at.

``ChipSpec.step_dispatch_ms`` is the per-step host dispatch floor the
pure roofline ignores (JAX keeps it as one module constant,
``analytic.STEP_DISPATCH_MS``; here it is per row, since the port's
served step is host-bound on the card).  The ``cpu`` row is JAX's CPU
sanity anchor with JAX's link rate and dispatch floor, so the port's CPU
predictions equal JAX's.  The ``h100`` row: HBM bandwidth and the
float32 rate outside the tensor cores from NVIDIA's H100 SXM data sheet
(the peaks ``chip_smoke.py`` bounds its kernels by); the host link and
the dispatch floor as ``chip_smoke.py``'s ``serve_a6b`` phase measured
them on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: the pinned
host-to-device rate of 256 MB copies (48.94 GB/s) and the p50 wall of
one chunked paged step of the served Transformer-base LM (8 slots, K 8,
a host-tier run: 8.46 ms).  The phase prints both again on every run,
beside the router's predictions.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float       # dense FLOP/s of the served arithmetic
    hbm_bytes_per_s: float  # device memory (DRAM for cpu) bandwidth
    # host <-> device link: the ceiling a host-tier restore streams under
    host_link_bytes_per_s: float = 16e9
    # per-step host dispatch floor (ms)
    step_dispatch_ms: float = 0.05

    @property
    def ridge_intensity(self):
        """FLOPs/byte where the roofline's two ceilings meet."""
        return self.peak_flops / self.hbm_bytes_per_s


SPECS = {
    "cpu": ChipSpec("cpu (sanity anchor)", 1e11, 50e9),
    "h100": ChipSpec("NVIDIA H100 SXM (float32, SIMT)", 67e12, 3.35e12,
                     host_link_bytes_per_s=48.94e9, step_dispatch_ms=8.46),
}


def spec_for(device):
    """The row a ``torch.device`` is priced at: ``h100`` for a CUDA
    device, ``cpu`` otherwise."""
    return SPECS["h100" if getattr(device, "type", device) == "cuda"
                 else "cpu"]


def predict(flops, bytes_accessed, spec):
    """Roofline prediction for one step on one chip spec: compute_ms /
    memory_ms (the two ceilings), predicted_ms (their max),
    predicted_mfu, the arithmetic intensity beside the ridge point, and
    the named bottleneck."""
    if isinstance(spec, str):
        spec = SPECS[spec]
    if flops < 0 or bytes_accessed < 0:
        raise ValueError("flops/bytes_accessed must be non-negative")
    compute_s = flops / spec.peak_flops
    memory_s = bytes_accessed / spec.hbm_bytes_per_s
    t = max(compute_s, memory_s)
    intensity = (flops / bytes_accessed) if bytes_accessed else float("inf")
    return {
        "chip": spec.name,
        "compute_ms": compute_s * 1e3,
        "memory_ms": memory_s * 1e3,
        "predicted_ms": t * 1e3,
        "predicted_mfu": (compute_s / t) if t > 0 else 0.0,
        "arithmetic_intensity": intensity,
        "ridge_intensity": spec.ridge_intensity,
        "bottleneck": "compute" if compute_s >= memory_s else "memory",
    }
