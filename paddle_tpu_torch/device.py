"""Device choice for the port's entry points.

The JAX package picks its backend from the environment and falls back to
the CPU; the port does not fall back.  An entry point runs on the card
unless its caller asks for the CPU by name (the tests do) or the process
flag ``use_gpu`` (``utils/flags.FLAGS``, the reference's flag) is False,
and with no card and no explicit CPU choice it raises.

Numerics in this slice are float32 on both devices.  PyTorch would run
float32 convolutions in TF32 through cuDNN by default, so both TF32
switches are set off here, where the device is set up.
"""

import subprocess

import torch


def resolve(device=None):
    """``torch.device`` for an entry point: ``None`` means the card, or
    the CPU when ``FLAGS.use_gpu`` is False.

    Raises ``RuntimeError`` when the card is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false."""
    if device is None:
        from paddle_tpu_torch.utils.flags import FLAGS
        device = "cuda" if FLAGS.use_gpu else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: the port runs on 'cuda' or "
                         "'cpu'")
    return dev


def card():
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them: the
    line every number measured on the card is written beside."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
