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

JAX's v2 convenience names (``paddle_tpu/__init__.py:31-36``) are here
too: ``init`` and ``infer`` (``trainer.api``), ``layer`` (the layer DSL)
and ``optimizer`` (``optim``).  They bind at first use, so importing
this package loads nothing beyond its version.
"""

import importlib as _importlib

from paddle_tpu_torch.version import __version__  # noqa: F401

# name -> (module, attribute or None for the module itself)
_LAZY = {"init": ("paddle_tpu_torch.trainer.api", "init"),
         "infer": ("paddle_tpu_torch.trainer.api", "infer"),
         "layer": ("paddle_tpu_torch.layers", None),
         "optimizer": ("paddle_tpu_torch.optim", None)}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module 'paddle_tpu_torch' has no attribute {name!r}")
    module, attr = _LAZY[name]
    value = _importlib.import_module(module)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value
