"""Hand-written Hopper kernels (``csrc/*.cu``) and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version beside it
and a plain integer ``launches`` that the wrapper bumps where it
launches the kernel, and nowhere else.  Dispatch is by the device of the
tensors handed in: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises — there is no fallback."""

from paddle_tpu_torch.ops.kernels import decode_attention, flash_attention
from paddle_tpu_torch.ops.kernels import gru, lstm, lstm_blocked

KERNELS = ("decode_attention", "flash_attention", "gru", "lstm",
           "lstm_blocked")


def build():
    """Build every kernel library now (one ``nvcc`` per source, all in
    parallel); returns {name: library path}."""
    from paddle_tpu_torch.ops.kernels import _build
    return _build.build_all(KERNELS)


def reset_launches():
    decode_attention.launches = 0
    decode_attention.launches_slab = 0
    decode_attention.launches_paged = 0
    decode_attention.launches_paged_chunk = 0
    decode_attention.launches_i8 = 0
    decode_attention.launches_slab_i8 = 0
    decode_attention.launches_paged_i8 = 0
    decode_attention.launches_paged_chunk_i8 = 0
    flash_attention.launches = 0
    flash_attention.launches_quant = 0
    flash_attention.launches_bwd_dkv = 0
    flash_attention.launches_bwd_dq = 0
    gru.launches_fwd = 0
    gru.launches_bwd = 0
    lstm.launches_fwd = 0
    lstm.launches_bwd = 0
    lstm_blocked.launches_fwd = 0


__all__ = ["decode_attention", "flash_attention", "gru", "lstm",
           "lstm_blocked", "KERNELS", "build", "reset_launches"]
