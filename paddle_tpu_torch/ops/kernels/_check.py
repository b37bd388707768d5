"""Argument checks shared by the kernel wrappers: the same checks run
whichever device the tensors are on, so a call the card's kernel would
refuse also fails on the CPU.  Also the constants of the recurrent
routes' rules, which the wrappers share."""

import torch

HEAD_DIMS = (16, 32, 64, 128)
# the flash kernels' wide compiled widths: the multiples of 128 above 128
# that their own tiling (csrc/flash_attention.cu, the _wide kernels) takes
WIDE_HEAD_DIMS = (256, 384, 512)
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


def flash_head_dim(dh):
    """A head dim the flash route runs on the kernels: any up to 128
    (padded to a compiled width) or a compiled wide one, 256, 384 or
    512.  JAX's ``flash_attention`` runs its kernel at every
    lane-tileable width and sends the others to the dense path; the
    port does the same, and also sends a multiple of 128 above 512 there
    (the same function; its kernels are not compiled that wide)."""
    return dh <= LANES or dh in WIDE_HEAD_DIMS


# the dtypes the recurrent kernels read and write an operand in (each
# pair of xs and weight dtypes has an instance, ``suffix`` names it)
RNN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}


def tensors(name, dtypes, **named):
    """Every tensor on one device, of an admitted dtype (``dtypes[arg]``:
    one dtype or a tuple of them), contiguous, 16-byte aligned (the
    kernels load 16 bytes at a time).  Returns the device."""
    dev = None
    for arg, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor")
        ok = dtypes[arg] if isinstance(dtypes[arg], tuple) \
            else (dtypes[arg],)
        if t.dtype not in ok:
            want = " or ".join(str(d) for d in ok)
            raise TypeError(f"{name}: {arg} must be {want}, got "
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


def same_dtype(name, ref_arg, ref, **named):
    """Each named tensor in ``ref``'s dtype (an output's cotangent or a
    residual of the forward that took ``ref``)."""
    for arg, t in named.items():
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {arg} must be {ref_arg}'s dtype "
                            f"{ref.dtype}, got {t.dtype}")


def suffix(xs_dtype, w_dtype):
    """The C entry suffix of a recurrent kernel's instance for (xs, W)'s
    dtypes (each in RNN_DTYPES): ``f32`` for float32 with float32 (the
    float32 kernels), else ``x<xs>_w<W>``.  Under the bf16 policy the
    JAX kernels receive ``xf32_wbf16`` (behind an fc) and
    ``xbf16_wbf16`` (fed by an embedding), under the float16 policy
    ``xf32_wf16`` and ``xf16_wf16``; the other pairs are a direct
    call's."""
    if xs_dtype == w_dtype == torch.float32:
        return "f32"
    return f"x{_SHORT[xs_dtype]}_w{_SHORT[w_dtype]}"


def operand_suffix(**operands):
    """The row name of an attention kernel's instance for these operand
    tensors: ``f32`` where every one is float32, else each operand's
    name and dtype (``qbf16_kf32_vbf16``)."""
    if all(t.dtype == torch.float32 for t in operands.values()):
        return "f32"
    short = {**_SHORT, torch.int8: "i8"}
    return "_".join(f"{name}{short[t.dtype]}" for name, t in operands.items())


def f32_scratch(out):
    """A float32 buffer the shape of ``out`` on its device: ``out`` itself
    where it is float32 (the float32 instance computes in its outputs)."""
    if out.dtype == torch.float32:
        return out
    return torch.empty(out.shape, dtype=torch.float32, device=out.device)


def count_low(counts, name, sfx):
    """One launch of the instance ``sfx`` of kernel ``name`` in
    ``counts`` (a wrapper's ``launches_low``, by row name
    ``<name>[<sfx>]``) unless it is the float32 one."""
    if sfx != "f32":
        key = f"{name}[{sfx}]"
        counts[key] = counts.get(key, 0) + 1
