"""The port's fused GRU (paddle_tpu_torch.ops.kernels.gru and
ops/rnn.gru) against the JAX package's, on the CPU.

The plain versions of the CUDA kernels are held against the Pallas
kernels themselves (``paddle_tpu.ops.pallas.gru._fwd`` / ``_bwd`` in
interpret mode, B=8, T=7, D=128 as tests/test_pallas_gru.py uses), and
``rnn.gru`` forward and gradients through ``GruFused`` against the JAX
``rnn.gru`` with its fused route forced on, and with it off (the scan).

Tolerances: as tests/test_pallas_gru.py:60, rtol 2e-4 and atol 2e-5 —
both sides compute in float32 but sum the recurrent products in
different orders (XLA vs PyTorch), which moves values by a few ulps per
step and compounds over the recurrence.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.ops.pallas import gru as pl_gru
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops.kernels import gru as kgru
from paddle_tpu_torch.utils.error import ConfigError

B, T, D = 8, 7, 128
RTOL, ATOL = 2e-4, 2e-5
KINDS = ("full", "ragged", "zero")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _lengths(rng, kind, b=B, t=T):
    if kind == "full":
        return np.full((b,), t, np.int32)
    lengths = rng.randint(1, t + 1, (b,)).astype(np.int32)
    if kind == "zero":
        lengths[0] = 0
    return lengths


@functools.lru_cache(maxsize=None)
def _kernel_case(kind):
    """Inputs at the JAX tests' scale (x*0.3, W*0.1) and the Pallas
    kernels' outputs on them, once per kind for the module."""
    rng = np.random.RandomState(KINDS.index(kind))
    xs = (rng.randn(T, B, 3 * D) * 0.3).astype(np.float32)
    w_gate = (rng.randn(D, 2 * D) * 0.1).astype(np.float32)
    w_state = (rng.randn(D, D) * 0.1).astype(np.float32)
    lengths = _lengths(rng, kind)
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    dh_out = rng.randn(T, B, D).astype(np.float32)
    lanes = jnp.broadcast_to(jnp.asarray(mask)[:, :, None], (T, B, 128))
    hs, acts = pl_gru._fwd(jnp.asarray(xs), jnp.asarray(w_gate),
                           jnp.asarray(w_state), lanes, True, True)
    lean, _ = pl_gru._fwd(jnp.asarray(xs), jnp.asarray(w_gate),
                          jnp.asarray(w_state), lanes, True, False)
    dxs, dwg, dws, _ = pl_gru._bwd(
        True, (jnp.asarray(w_gate), jnp.asarray(w_state), lanes, hs, acts),
        jnp.asarray(dh_out))
    inputs = dict(xs=xs, mask=mask, w_gate=w_gate, w_state=w_state,
                  dh_out=dh_out, lengths=lengths)
    want = {k: np.asarray(v) for k, v in dict(
        hs=hs, acts=acts, lean=lean, dxs=dxs, dwg=dwg, dws=dws).items()}
    return inputs, want


@pytest.mark.parametrize("kind", KINDS)
def test_plain_forward_matches_pallas_kernel(kind):
    inp, want = _kernel_case(kind)
    args = [torch.tensor(inp[k]) for k in ("xs", "mask", "w_gate", "w_state")]
    hs, acts = kgru.gru_fwd(*args, save_residuals=True)
    _close(hs, want["hs"], "hs")
    _close(acts, want["acts"], "acts")
    lean, none = kgru.gru_fwd(*args, save_residuals=False)
    assert none is None
    _close(lean, want["lean"], "lean hs")
    # the lean hs is the residual hs bit for bit
    torch.testing.assert_close(lean, hs, rtol=0, atol=0)
    if kind == "zero":     # a row of length 0 stays exactly 0
        assert not hs[:, 0].any()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_backward_matches_pallas_kernel(kind):
    inp, want = _kernel_case(kind)
    got = kgru.gru_bwd(*(torch.tensor(a) for a in (
        want["acts"], want["hs"], inp["w_gate"], inp["w_state"], inp["mask"],
        inp["dh_out"])))
    for name, g, w in zip(("dxs", "dW_gate", "dW_state"), got,
                          (want["dxs"], want["dwg"], want["dws"])):
        _close(g, w, name)
    if kind == "zero":     # a row of length 0 gets exactly 0 gradient
        assert not got[0][:, 0].any()


def _seq_inputs(kind):
    rng = np.random.RandomState(10 + KINDS.index(kind))
    x = (rng.randn(B, T, 3 * D) * 0.3).astype(np.float32)
    w_gate = (rng.randn(D, 2 * D) * 0.1).astype(np.float32)
    w_state = (rng.randn(D, D) * 0.1).astype(np.float32)
    bias = (rng.randn(3 * D) * 0.1).astype(np.float32)
    return x, _lengths(rng, kind), w_gate, w_state, bias


@functools.lru_cache(maxsize=None)
def _jax_gru(kind, reverse, fused):
    """loss and grads (x, w_gate, w_state, bias) of the JAX rnn.gru with
    its fused route forced on (interpret mode, as
    tests/test_pallas_gru.py:29-38 does) or off (the scan)."""
    x, lengths, w_gate, w_state, bias = _seq_inputs(kind)

    def loss(x, wg, ws, b):
        out, final = jax_rnn.gru(JaxSeq(x, jnp.asarray(lengths)), wg, ws,
                                 bias=b, reverse=reverse)
        return jnp.sum(out.data ** 2) + jnp.sum(final ** 2)
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always" if fused else "0"
    try:
        val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (x, w_gate, w_state, bias)))
    finally:
        jax_rnn.FUSED_LSTM = prior
    return float(val), [np.asarray(g) for g in grads]


def _torch_gru(kind, reverse, **kw):
    x, lengths, w_gate, w_state, bias = _seq_inputs(kind)
    args = [torch.tensor(a, requires_grad=True)
            for a in (x, w_gate, w_state, bias)]
    out, final = rnn.gru(SequenceBatch(args[0], torch.tensor(lengths)),
                         args[1], args[2], bias=args[3], reverse=reverse,
                         **kw)
    loss = (out.data ** 2).sum() + (final ** 2).sum()
    loss.backward()
    return float(loss.detach()), [a.grad for a in args], out, final


@pytest.mark.parametrize("fused", [True, False], ids=["jax_fused",
                                                      "jax_scan"])
@pytest.mark.parametrize("kind, reverse", [
    ("full", False), ("ragged", False), ("zero", False), ("ragged", True),
    ("zero", True)])
def test_rnn_gru_matches_jax(kind, reverse, fused):
    """The port's fused route (GruFused, the plain versions on the CPU)
    against JAX's fused route in interpret mode and against its scan."""
    want_loss, want_grads = _jax_gru(kind, reverse, fused)
    loss, grads, out, _ = _torch_gru(kind, reverse)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    for name, g, w in zip(("dx", "dw_gate", "dw_state", "dbias"), grads,
                          want_grads):
        _close(g, w, name)
    lengths = _seq_inputs(kind)[1]
    for row, n in enumerate(lengths):     # padding is exactly 0
        assert not out.data[row, n:].any()


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_route_matches_port_scan(reverse):
    """The fused route against the port's own scan (a callable tanh is
    not the name "tanh", so the rule fails and ``gru`` scans)."""
    loss, grads, out, final = _torch_gru("zero", reverse)
    loss_s, grads_s, out_s, final_s = _torch_gru("zero", reverse,
                                                 act=torch.tanh)
    np.testing.assert_allclose(loss, loss_s, rtol=2e-5)
    _close(out.data.detach(), out_s.data.detach(), "out")
    _close(final.detach(), final_s.detach(), "final")
    for g, w in zip(grads, grads_s):
        _close(g, w, "grad")


GRID = [(b, d, act, gate_act, init)
        for b in (8, 12, 64, 96)
        for d in (128, 192, 512, 640, 768, 896)
        for act, gate_act, init in (("tanh", "sigmoid", None),
                                    ("relu", "sigmoid", None),
                                    ("tanh", "tanh", None),
                                    ("tanh", "sigmoid", "given"))]


def test_route_rule_matches_jax_supported():
    """The port's copy of gru.supported gives JAX's answer over the grid
    (B not a multiple of 8, D not a multiple of 128, non-default
    activations, an initial state, D past the VMEM guard), and every
    (B, D) it admits is one the kernels take."""
    admitted = set()
    for b, d, act, gate_act, init in GRID:
        want = pl_gru.supported(b, d, act, gate_act, init)
        assert kgru.supported(b, d, act, gate_act, init) == want, \
            (b, d, act, gate_act, init)
        assert kgru.vmem_bytes(b, d) == pl_gru.vmem_bytes(b, d)
        if want:
            admitted.add((b, d))
            kgru._shapes(kgru.NAME_FWD, torch.zeros(1, b, 3 * d),
                         torch.zeros(1, b), torch.zeros(d, 2 * d),
                         torch.zeros(d, d), torch.device("cuda"))
    assert (64, 640) in admitted and (8, 768) in admitted
    assert (64, 768) not in admitted and (8, 896) not in admitted
    assert kgru.vmem_bytes(64, 512) == 7_634_944


@pytest.mark.parametrize("mb", ["0.5", "64"])
def test_route_ignores_the_tpu_vmem_override(monkeypatch, mb):
    """The budget is the JAX package's default, a constant: the TPU's
    PADDLE_TPU_KERNEL_VMEM_MB override neither sends the train shape to
    the scan nor admits a D the kernels refuse."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_VMEM_MB", mb)
    assert kgru.VMEM_BUDGET == 14 * 1024 * 1024
    assert kgru.supported(64, 512, "tanh", "sigmoid", None)
    assert not kgru.supported(64, 768, "tanh", "sigmoid", None)
    assert not kgru.supported(8, 896, "tanh", "sigmoid", None)


@pytest.mark.parametrize("b, kw", [
    (12, {}), (8, {"act": "relu"}), (8, {"gate_act": "tanh"}),
    (8, {"init_state": "zeros"})])
def test_unsupported_config_scans_on_either_device(b, kw):
    """Where the rule fails, ``gru`` runs the masked scan of ``gru_cell``
    — the reference's own route — and matches the JAX scan; the route
    does not depend on the device: on a device that no kernel wrapper
    takes ("meta") the scan still runs, where the fused route would
    raise."""
    rng = np.random.RandomState(3)
    x = (rng.randn(b, T, 3 * D) * 0.3).astype(np.float32)
    lengths = _lengths(rng, "zero", b=b)
    w_gate = (rng.randn(D, 2 * D) * 0.1).astype(np.float32)
    w_state = (rng.randn(D, D) * 0.1).astype(np.float32)
    init = (rng.randn(b, D) * 0.5).astype(np.float32)
    jkw = dict(kw, init_state=jnp.asarray(init)) if "init_state" in kw \
        else kw
    tkw = dict(kw, init_state=torch.tensor(init)) if "init_state" in kw \
        else kw
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "0"
    try:
        want, want_final = jax_rnn.gru(
            JaxSeq(jnp.asarray(x), jnp.asarray(lengths)),
            jnp.asarray(w_gate), jnp.asarray(w_state), reverse=True, **jkw)
    finally:
        jax_rnn.FUSED_LSTM = prior
    kgru.launches_fwd = kgru.launches_bwd = 0
    got, final = rnn.gru(SequenceBatch(torch.tensor(x),
                                       torch.tensor(lengths)),
                         torch.tensor(w_gate), torch.tensor(w_state),
                         reverse=True, **tkw)
    _close(got.data, want.data, "out")
    _close(final, want_final, "final")
    meta = torch.device("meta")
    out, _ = rnn.gru(
        SequenceBatch(torch.zeros(b, T, 3 * D, device=meta),
                      torch.zeros(b, dtype=torch.int32, device=meta)),
        torch.zeros(D, 2 * D, device=meta), torch.zeros(D, D, device=meta),
        **{k: (v if k != "init_state" else torch.zeros(b, D, device=meta))
           for k, v in kw.items()})
    assert out.data.shape == (b, T, D)
    with pytest.raises(ValueError, match="on meta"):     # the fused route
        rnn.gru(SequenceBatch(torch.zeros(8, T, 3 * D, device=meta),
                              torch.zeros(8, dtype=torch.int32,
                                          device=meta)),
                torch.zeros(D, 2 * D, device=meta),
                torch.zeros(D, D, device=meta))
    assert (kgru.launches_fwd, kgru.launches_bwd) == (0, 0)


def test_gru_cell_matches_jax():
    rng = np.random.RandomState(4)
    x3 = rng.randn(5, 3 * 16).astype(np.float32)
    h = rng.randn(5, 16).astype(np.float32)
    wg = (rng.randn(16, 32) * 0.3).astype(np.float32)
    ws = (rng.randn(16, 16) * 0.3).astype(np.float32)
    for act, gate_act in (("tanh", "sigmoid"), ("relu", "tanh")):
        want = jax_rnn.gru_cell(*(jnp.asarray(a) for a in (x3, h, wg, ws)),
                                act=act, gate_act=gate_act)
        got = rnn.gru_cell(*(torch.tensor(a) for a in (x3, h, wg, ws)),
                           act=act, gate_act=gate_act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d, match", [(896, "hidden size 896"),
                                      (192, "hidden size 192")])
def test_wrapper_refuses_hidden_sizes_the_kernels_lack(d, match):
    """A CUDA tensor of a hidden size the kernels do not take raises in
    the wrapper's shape check (checked here on the shapes alone); the
    plain versions take it on the CPU."""
    xs, mask = torch.zeros(2, 8, 3 * d), torch.ones(2, 8)
    wg, ws = torch.zeros(d, 2 * d), torch.zeros(d, d)
    with pytest.raises(ConfigError, match=match):
        kgru._shapes(kgru.NAME_FWD, xs, mask, wg, ws, torch.device("cuda"))
    hs, _ = kgru.gru_fwd(xs, mask, wg, ws, False)
    assert hs.shape == (2, 8, d) and not hs.any()


def test_wrapper_checks_dtype_and_shapes():
    xs, mask = torch.zeros(2, 8, 384), torch.ones(2, 8)
    wg, ws = torch.zeros(128, 256), torch.zeros(128, 128)
    with pytest.raises(TypeError, match="float32"):
        kgru.gru_fwd(xs.double(), mask, wg, ws, False)
    with pytest.raises(TypeError, match="float32"):
        kgru.gru_fwd(xs, mask.to(torch.int32), wg, ws, False)
    with pytest.raises(ValueError, match="mask"):
        kgru.gru_fwd(xs, torch.ones(8, 2), wg, ws, False)
    with pytest.raises(ValueError, match="w_state"):
        kgru.gru_fwd(xs, mask, wg, torch.zeros(128, 256), False)
    with pytest.raises(ValueError, match=r"\[T, B, 3D\]"):
        kgru.gru_fwd(torch.zeros(2, 8, 385), mask, wg, ws, False)
    with pytest.raises(ValueError, match="empty"):
        kgru.gru_fwd(torch.zeros(0, 8, 384), torch.ones(0, 8), wg, ws, False)
    with pytest.raises(ValueError, match="contiguous"):
        kgru.gru_fwd(torch.zeros(8, 2, 384).transpose(0, 1), mask, wg, ws,
                     False)
    acts = torch.zeros(2, 8, 384)
    with pytest.raises(ValueError, match="dh_out"):
        kgru.gru_bwd(acts, torch.zeros(2, 8, 128), wg, ws, mask,
                     torch.zeros(2, 8, 127))


def test_c_entries_are_typed(monkeypatch):
    """``_build.entry`` types a C entry as pointers, ints, the given
    tail and the stream, returning an int (checked on libc's ``strncmp``
    standing in for a kernel library: no library is built here)."""
    import ctypes
    import ctypes.util
    from paddle_tpu_torch.ops.kernels import _build
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    monkeypatch.setattr(_build, "load", lambda lib: libc)
    fn = _build.entry("c", "strncmp", 2, 0)
    assert fn.argtypes == [ctypes.c_void_p] * 3 and fn.restype is ctypes.c_int
    a, b = ctypes.create_string_buffer(b"abcd"), ctypes.create_string_buffer(
        b"abcz")
    assert fn(ctypes.addressof(a), ctypes.addressof(b), 3) == 0
    assert fn(ctypes.addressof(a), ctypes.addressof(b), 4) < 0
    assert _build.entry("c", "strncmp", 2, 0) is fn      # typed once
    tail = _build.entry("c", "abs", 0, 1, ctypes.c_float)
    assert tail.argtypes == [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def test_gru_c_entries_match_the_source():
    """Each C entry of ``csrc/gru.cu`` is typed where it is called (the
    wrapper, chip_smoke.py's 3xTF32 control and barrier probe) as its
    signature reads: one entry per kernel and instance
    (``_check.suffix`` of every pair of ``RNN_DTYPES``) declaring the pointer and int counts
    handed to ``_build.entry`` (FWD_ARGS, BWD_ARGS, or the literal
    counts) before the trailing stream, so ctypes passes no pointer as a
    32-bit int."""
    import os
    import re
    from paddle_tpu_torch.ops.kernels import _check
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, kgru.SOURCE)) as f:
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', f.read()))
    want = {f"{name}_{s}": args
            for name, args in ((kgru.NAME_FWD, kgru.FWD_ARGS),
                               (kgru.NAME_BWD, kgru.BWD_ARGS))
            for s in {_check.suffix(x, w) for x in _check.RNN_DTYPES
                      for w in _check.RNN_DTYPES}}
    with open(kgru.__file__) as f:
        lookups = re.findall(r'_build\.entry\("gru", f"\{(NAME_\w+)\}_'
                             r'\{sfx\}", \*(\w+)\)', f.read())
    assert lookups == [("NAME_FWD", "FWD_ARGS"), ("NAME_BWD", "BWD_ARGS")]
    with open(os.path.join(root, "chip_smoke.py")) as f:
        smoke = f.read()
    for name, args in re.findall(r'_build\.entry\("gru", "(\w+)", '
                                 r'\*gk\.(\w+)\)', smoke):
        assert want[name] == getattr(kgru, args), name
    literal = {name: (int(p), int(i)) for name, p, i in re.findall(
        r'_build\.entry\("gru", "(\w+)", (\d+), (\d+)\)', smoke)}
    assert sorted(decls) == sorted({**want, **literal})
    for name, (n_ptr, n_int) in {**want, **literal}.items():
        params = [p.strip() for p in decls[name].split(",")]
        assert params[-1] == "void* stream"
        kinds = ["ptr" if "*" in p else p.split()[0] for p in params[:-1]]
        assert kinds == ["ptr"] * n_ptr + ["int"] * n_int, name


def test_cpu_takes_plain_versions_and_counts_no_launch():
    kgru.launches_fwd = kgru.launches_bwd = 0
    _torch_gru("ragged", False)          # residual forward + backward
    x, lengths, w_gate, w_state, _ = _seq_inputs("ragged")
    with torch.no_grad():                # the lean forward
        out, final = rnn.gru(SequenceBatch(torch.tensor(x),
                                           torch.tensor(lengths)),
                             torch.tensor(w_gate), torch.tensor(w_state))
    assert out.data.shape == (B, T, D) and final.shape == (B, D)
    assert (kgru.launches_fwd, kgru.launches_bwd) == (0, 0)
