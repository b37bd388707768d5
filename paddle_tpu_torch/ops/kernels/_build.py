"""Build and load the hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled on first use by ``nvcc`` for ``sm_90a`` into its own shared
library, loaded with ``ctypes``.  Sources that include PyTorch's headers
take minutes to build; a plain C interface takes seconds.

Libraries land in ``paddle_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  ``build_all`` starts one ``nvcc`` per
source together and waits for all of them.  A source in ``PARTS`` builds
as that many objects, each by its own ``nvcc`` with ``-DPT_PART=k`` (the
source defines part k's C entries, ``PT_IN(k)``), all at once, then
linked into its one library: its instances take most of a build, and one
``nvcc`` compiles on one core.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
# sources built in parts: part 0 holds the float32 (and int8) entries,
# the others the low-precision instances (the sources' PT_IN)
PARTS = {"flash_attention": 2, "gru": 4, "lstm": 4, "lstm_blocked": 4,
         "simple_rnn": 4}
# the flags of a build of part 0 alone: the float32 entries, which the
# probes (scripts/probe_*.py) build their variants from
F32_PART = ("-DPT_PART=0",)

_lock = threading.Lock()
_libs = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the port's "
                           "kernels are built on the machine with the card")
    return path


def _target(name):
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()
                                + str(PARTS.get(name, 1)).encode())
    return src, os.path.join(BUILD_DIR,
                             f"{name}.{digest.hexdigest()[:16]}.so")


def _nvcc_proc(args):
    return subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _wait(name, proc):
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{out}")


def _start(name):
    """Start nvcc for ``name`` (one process, or one a part) unless its
    library is built; returns (processes, temp path, final path)."""
    src, so = _target(name)
    if os.path.exists(so):
        return [], None, so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    parts = PARTS.get(name)
    if parts is None:
        return [_nvcc_proc([*FLAGS, "-o", tmp, src])], tmp, so
    compile_flags = [f for f in FLAGS if f != "-shared"]
    return [_nvcc_proc([*compile_flags, f"-DPT_PART={k}", "-c", "-o",
                        f"{tmp}.{k}.o", src]) for k in range(parts)], tmp, so


def _finish(name, procs, tmp, so):
    if tmp is not None:
        for proc in procs:
            _wait(name, proc)
        parts = PARTS.get(name)
        if parts is not None:     # link the parts into the library
            objs = [f"{tmp}.{k}.o" for k in range(parts)]
            _wait(name, _nvcc_proc([*FLAGS, "-o", tmp, *objs]))
            for obj in objs:
                os.remove(obj)
        os.replace(tmp, so)       # atomic: a concurrent loader sees all
    return so


def build_all(names):
    """Build every named kernel library, all ``nvcc`` runs in parallel.
    Returns {name: library path}."""
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n]) for n in names}


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_finish(name, *_start(name)))
            _libs[name] = lib
        return lib


def entry(lib, name, n_ptr, n_int, *tail):
    """The C entry ``name`` of ``csrc/<lib>.cu``, typed: ``n_ptr``
    pointers, ``n_int`` ints, the ctypes in ``tail``, then the stream;
    it returns a ``cudaError_t`` (an int)."""
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + list(tail) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check(name, rc):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry (the
    ``cudaGetLastError()`` right after the launch: a refused launch never
    runs and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
