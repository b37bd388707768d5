"""Argument checks shared by the kernel wrappers: the same checks run
whichever device the tensors are on, so a call the card's kernel would
refuse also fails on the CPU.  Also the constants of the recurrent
routes' rules, which the wrappers share."""

import torch

HEAD_DIMS = (16, 32, 64, 128)
# The TPU's lane width: the recurrent routes admit hidden sizes in
# multiples of it.
LANES = 128
# The JAX package's default kernel VMEM budget
# (``paddle_tpu/ops/pallas/common.py:24-31``), kept as a constant: the
# recurrent routes must admit the same (B, D) as the reference, and the
# TPU's override of it (``PADDLE_TPU_KERNEL_VMEM_MB``) has no meaning on
# a GPU.
VMEM_BUDGET = 14 * 1024 * 1024


def lane_tileable(n):
    """A width the TPU kernels' lanes slice (n <= 128) or tile (n % 128
    == 0): the head dims the reference's attention kernels take."""
    return n <= LANES or n % LANES == 0


def tensors(name, dtypes, **named):
    """Every tensor on one device, of its dtype, contiguous, 16-byte
    aligned (the kernels load float4s).  Returns the device."""
    dev = None
    for arg, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor")
        if t.dtype != dtypes[arg]:
            raise TypeError(f"{name}: {arg} must be {dtypes[arg]}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev} (takes cpu or cuda)")
    return dev

