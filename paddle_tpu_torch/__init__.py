"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``, for one
NVIDIA Hopper card (H100).

The JAX package ``paddle_tpu`` stays beside this one as the reference:
every module here names its JAX counterpart, keeps its public
functions' layouts and parameter-tree keys, and is held against it by
``tests/test_torch_*.py``.  This package imports torch and numpy only —
never jax and never ``paddle_tpu`` (whose ``__init__`` imports jax).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve``).  Kernels dispatch by the device of the tensor
they are handed: a CUDA tensor launches the hand-written Hopper kernel
(``ops/kernels``), a CPU tensor takes its plain PyTorch version.
"""

from paddle_tpu_torch.version import __version__  # noqa: F401
