"""The port's fused vanilla RNN (paddle_tpu_torch.ops.kernels.simple_rnn
and ops/rnn.simple_rnn) against the JAX package's, on the CPU.

The plain versions of the CUDA kernels are held against the Pallas
kernels themselves (``paddle_tpu.ops.pallas.simple_rnn._fwd`` / ``_bwd``
in interpret mode, T=7, B=8, D=128), and ``rnn.simple_rnn`` forward and
gradients through ``SimpleRnnFused`` against the JAX ``rnn.simple_rnn``
with its fused route forced on, and with it off (the scan).

Tolerances: the plain versions against the Pallas kernels within 1e-5
absolute (hs, dxs: O(1) values) and 1e-5 of dW's largest entry — the
same float32 arithmetic in other summation orders, a few ulps a step
over 7 steps.  ``rnn.simple_rnn`` against JAX at rtol 2e-4 / atol 2e-5,
as tests/test_torch_gru.py holds the GRU (the losses sum the squares of
every output).
"""

import functools
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu.ops.pallas import simple_rnn as pl_rnn
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops.kernels import _check
from paddle_tpu_torch.ops.kernels import simple_rnn as krnn
from paddle_tpu_torch.utils.error import ConfigError

B, T, D = 8, 7, 128
KERNEL_TOL = 1e-5
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
    """Inputs (x*0.3, W at the layer's std 1/sqrt(D)) and the Pallas
    kernels' outputs on them, once per kind for the module."""
    rng = np.random.RandomState(KINDS.index(kind))
    xs = (rng.randn(T, B, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)
    lengths = _lengths(rng, kind)
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    dh_out = rng.randn(T, B, D).astype(np.float32)
    lanes = jnp.broadcast_to(jnp.asarray(mask)[:, :, None], (T, B, 128))
    hs = pl_rnn._fwd(jnp.asarray(xs), jnp.asarray(w), lanes, True)
    dxs, dw, _ = pl_rnn._bwd(True, (jnp.asarray(w), lanes, hs),
                             jnp.asarray(dh_out))
    inputs = dict(xs=xs, mask=mask, w=w, dh_out=dh_out)
    want = {k: np.asarray(v) for k, v in dict(hs=hs, dxs=dxs, dw=dw).items()}
    return inputs, want


@pytest.mark.parametrize("kind", KINDS)
def test_plain_forward_matches_pallas_kernel(kind):
    inp, want = _kernel_case(kind)
    hs = krnn.simple_rnn_fwd(*(torch.tensor(inp[k])
                               for k in ("xs", "mask", "w")))
    assert float(np.abs(hs.numpy() - want["hs"]).max()) <= KERNEL_TOL
    if kind == "zero":     # a row of length 0 stays exactly 0
        assert not hs[:, 0].any()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_backward_matches_pallas_kernel(kind):
    inp, want = _kernel_case(kind)
    dxs, dw = krnn.simple_rnn_bwd(*(torch.tensor(a) for a in (
        want["hs"], inp["w"], inp["mask"], inp["dh_out"])))
    assert float(np.abs(dxs.numpy() - want["dxs"]).max()) <= KERNEL_TOL
    assert float(np.abs(dw.numpy() - want["dw"]).max()) \
        <= KERNEL_TOL * float(np.abs(want["dw"]).max())
    if kind == "zero":     # a row of length 0 gets exactly 0 gradient
        assert not dxs[:, 0].any()


def _seq_inputs(kind, b=B):
    rng = np.random.RandomState(10 + KINDS.index(kind))
    x = (rng.randn(b, T, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)
    bias = (rng.randn(D) * 0.1).astype(np.float32)
    return x, _lengths(rng, kind, b=b), w, bias


@functools.lru_cache(maxsize=None)
def _jax_rnn(kind, reverse, fused):
    """loss and grads (x, w, bias) of the JAX rnn.simple_rnn with its
    fused route forced on (interpret mode) or off (the scan)."""
    x, lengths, w, bias = _seq_inputs(kind)

    def loss(x, w, b):
        out, final = jax_rnn.simple_rnn(JaxSeq(x, jnp.asarray(lengths)), w,
                                        bias=b, reverse=reverse)
        return jnp.sum(out.data ** 2) + jnp.sum(final ** 2)
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always" if fused else "0"
    try:
        dispatched = jax_rnn.FUSED_DISPATCH_COUNT
        val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
            *(jnp.asarray(a) for a in (x, w, bias)))
        assert (jax_rnn.FUSED_DISPATCH_COUNT > dispatched) == fused
    finally:
        jax_rnn.FUSED_LSTM = prior
    return float(val), [np.asarray(g) for g in grads]


def _torch_rnn(kind, reverse, **kw):
    x, lengths, w, bias = _seq_inputs(kind)
    args = [torch.tensor(a, requires_grad=True) for a in (x, w, bias)]
    out, final = rnn.simple_rnn(SequenceBatch(args[0], torch.tensor(lengths)),
                                args[1], bias=args[2], reverse=reverse, **kw)
    loss = (out.data ** 2).sum() + (final ** 2).sum()
    loss.backward()
    return float(loss.detach()), [a.grad for a in args], out, final


@pytest.mark.parametrize("fused", [True, False], ids=["jax_fused",
                                                      "jax_scan"])
@pytest.mark.parametrize("kind, reverse", [
    ("full", False), ("zero", False), ("ragged", True), ("zero", True)])
def test_rnn_simple_rnn_matches_jax(kind, reverse, fused):
    """The port's fused route (SimpleRnnFused, the plain versions on the
    CPU) against JAX's fused route in interpret mode and its scan."""
    want_loss, want_grads = _jax_rnn(kind, reverse, fused)
    krnn.launches_fwd = krnn.launches_bwd = 0
    loss, grads, out, _ = _torch_rnn(kind, reverse)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    for name, g, w in zip(("dx", "dw", "dbias"), grads, want_grads):
        _close(g, w, name)
    lengths = _seq_inputs(kind)[1]
    for row, n in enumerate(lengths):     # padding is exactly 0
        assert not out.data[row, n:].any()
    # the CPU takes the plain versions and counts no launch
    assert (krnn.launches_fwd, krnn.launches_bwd) == (0, 0)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_route_matches_port_scan(reverse):
    """The fused route against the port's own scan (a callable tanh is
    not the name "tanh", so the rule fails and ``simple_rnn`` scans)."""
    loss, grads, out, final = _torch_rnn("zero", reverse)
    loss_s, grads_s, out_s, final_s = _torch_rnn("zero", reverse,
                                                 act=torch.tanh)
    np.testing.assert_allclose(loss, loss_s, rtol=2e-5)
    _close(out.data.detach(), out_s.data.detach(), "out")
    _close(final.detach(), final_s.detach(), "final")
    for g, w in zip(grads, grads_s):
        _close(g, w, "grad")


GRID = [(b, d, act, init)
        for b in (8, 12, 64, 4736, 4744)
        for d in (128, 192, 512, 1152, 1280, 1408)
        for act, init in (("tanh", None), ("relu", None),
                          ("tanh", "given"))]


def test_route_rule_matches_jax_supported():
    """The port's copy of simple_rnn.supported gives JAX's answer over
    the grid (B not a multiple of 8, D not a multiple of 128, relu, an
    initial state, D and B past the VMEM guard), and every (B, D) it
    admits is one the kernels take."""
    admitted = set()
    for b, d, act, init in GRID:
        want = pl_rnn.supported(b, d, act, init)
        assert krnn.supported(b, d, act, init) == want, (b, d, act, init)
        assert krnn.vmem_bytes(b, d) == pl_rnn.vmem_bytes(b, d)
        if want:
            admitted.add((b, d))
            krnn._shapes(krnn.NAME_FWD, torch.zeros(1, b, d),
                         torch.zeros(1, b), torch.zeros(d, d),
                         torch.device("cuda"))
    # the rule's extremes: D 1152 at B 64, D 1280 at B 8, B 4736 at D 128
    assert {(64, 1152), (8, 1280), (4736, 128)} <= admitted
    assert not {(64, 1280), (8, 1408), (4744, 128)} & admitted
    assert krnn.vmem_bytes(64, 512) == 2_785_280     # the train shape


@pytest.mark.parametrize("mb", ["0.5", "64"])
def test_route_ignores_the_tpu_vmem_override(monkeypatch, mb):
    """The budget is the JAX package's default, a constant."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_VMEM_MB", mb)
    assert krnn.VMEM_BUDGET == 14 * 1024 * 1024
    assert krnn.supported(64, 512, "tanh", None)
    assert not krnn.supported(64, 1280, "tanh", None)


@pytest.mark.parametrize("b, kw", [
    (12, {}), (8, {"act": "relu"}), (8, {"init_state": "given"})])
def test_unsupported_config_scans_on_either_device(b, kw):
    """Where the rule fails, ``simple_rnn`` runs the masked scan of
    ``simple_rnn_cell`` — the reference's own route — and matches the
    JAX scan; the route does not depend on the device: on a device that
    no kernel wrapper takes ("meta") the scan still runs, where the fused
    route raises."""
    rng = np.random.RandomState(3)
    x = (rng.randn(b, T, D) * 0.3).astype(np.float32)
    lengths = _lengths(rng, "zero", b=b)
    w = (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)
    init = (rng.randn(b, D) * 0.5).astype(np.float32)
    jkw = dict(kw, init_state=jnp.asarray(init)) if "init_state" in kw \
        else kw
    tkw = dict(kw, init_state=torch.tensor(init)) if "init_state" in kw \
        else kw
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always"      # the rule, not the flag, says scan
    try:
        dispatched = jax_rnn.FUSED_DISPATCH_COUNT
        want, want_final = jax_rnn.simple_rnn(
            JaxSeq(jnp.asarray(x), jnp.asarray(lengths)), jnp.asarray(w),
            reverse=True, **jkw)
        assert jax_rnn.FUSED_DISPATCH_COUNT == dispatched
    finally:
        jax_rnn.FUSED_LSTM = prior
    krnn.launches_fwd = krnn.launches_bwd = 0
    got, final = rnn.simple_rnn(SequenceBatch(torch.tensor(x),
                                              torch.tensor(lengths)),
                                torch.tensor(w), reverse=True, **tkw)
    _close(got.data, want.data, "out")
    _close(final, want_final, "final")
    meta = torch.device("meta")
    out, _ = rnn.simple_rnn(
        SequenceBatch(torch.zeros(b, T, D, device=meta),
                      torch.zeros(b, dtype=torch.int32, device=meta)),
        torch.zeros(D, D, device=meta),
        **{k: (v if k != "init_state" else torch.zeros(b, D, device=meta))
           for k, v in kw.items()})
    assert out.data.shape == (b, T, D)
    with pytest.raises(ValueError, match="on meta"):     # the fused route
        rnn.simple_rnn(SequenceBatch(torch.zeros(8, T, D, device=meta),
                                     torch.zeros(8, dtype=torch.int32,
                                                 device=meta)),
                       torch.zeros(D, D, device=meta))
    assert (krnn.launches_fwd, krnn.launches_bwd) == (0, 0)


def test_simple_rnn_cell_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 16).astype(np.float32)
    h = rng.randn(5, 16).astype(np.float32)
    w = (rng.randn(16, 16) * 0.3).astype(np.float32)
    for act in ("tanh", "relu", "sigmoid"):
        want = jax_rnn.simple_rnn_cell(*(jnp.asarray(a) for a in (x, h, w)),
                                       act=act)
        got = rnn.simple_rnn_cell(*(torch.tensor(a) for a in (x, h, w)),
                                  act=act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b, d", [(12, 128), (8, 192), (64, 1280),
                                  (8, 1408), (4744, 128)])
def test_wrapper_refuses_shapes_the_rule_does_not_admit(b, d):
    """On the card the kernels take exactly what the rule admits: any
    other (B, D) raises in the wrapper's shape check (checked here on the
    shapes alone); the plain versions take it on the CPU."""
    xs, mask, w = torch.zeros(2, b, d), torch.ones(2, b), torch.zeros(d, d)
    with pytest.raises(ConfigError, match=rf"\({b}, {d}\)"):
        krnn._shapes(krnn.NAME_FWD, xs, mask, w, torch.device("cuda"))
    if b * d <= 8 * 1408:
        hs = krnn.simple_rnn_fwd(xs, mask, w)
        assert hs.shape == (2, b, d) and not hs.any()


def test_wrapper_checks_dtype_and_shapes():
    xs, mask, w = torch.zeros(2, 8, 128), torch.ones(2, 8), torch.zeros(
        128, 128)
    with pytest.raises(TypeError, match="float32"):
        krnn.simple_rnn_fwd(xs.double(), mask, w)
    with pytest.raises(TypeError, match="float32"):
        krnn.simple_rnn_fwd(xs, mask.to(torch.int32), w)
    with pytest.raises(ValueError, match="mask"):
        krnn.simple_rnn_fwd(xs, torch.ones(8, 2), w)
    with pytest.raises(ValueError, match="w"):
        krnn.simple_rnn_fwd(xs, mask, torch.zeros(128, 256))
    with pytest.raises(ValueError, match=r"\[T, B, D\]"):
        krnn.simple_rnn_fwd(torch.zeros(8, 128), mask, w)
    with pytest.raises(ValueError, match="empty"):
        krnn.simple_rnn_fwd(torch.zeros(0, 8, 128), torch.ones(0, 8), w)
    with pytest.raises(ValueError, match="contiguous"):
        krnn.simple_rnn_fwd(torch.zeros(8, 2, 128).transpose(0, 1), mask, w)
    with pytest.raises(ValueError, match="dh_out"):
        krnn.simple_rnn_bwd(xs, w, mask, torch.zeros(2, 8, 127))


def test_c_entries_are_typed():
    """Each C entry the wrapper calls is typed as its signature in
    ``csrc/simple_rnn.cu`` reads: one entry per kernel and instance
    (``_check.suffix`` of every pair of ``RNN_DTYPES``), each declaring the pointer and int
    counts the wrapper hands ``_build.entry`` (FWD_ARGS, BWD_ARGS)
    before the trailing stream, so ctypes passes no pointer as a 32-bit
    int."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, krnn.SOURCE)) as f:
        src = f.read()
    with open(krnn.__file__) as f:
        wrapper = f.read()
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    want = {f"{name}_{s}": args
            for name, args in ((krnn.NAME_FWD, krnn.FWD_ARGS),
                               (krnn.NAME_BWD, krnn.BWD_ARGS))
            for s in {_check.suffix(x, w) for x in _check.RNN_DTYPES
                      for w in _check.RNN_DTYPES}}
    assert sorted(decls) == sorted(want)
    for name, (n_ptr, n_int) in want.items():
        params = [p.strip() for p in decls[name].split(",")]
        assert params[-1] == "void* stream"
        kinds = ["ptr" if "*" in p else p.split()[0] for p in params[:-1]]
        assert kinds == ["ptr"] * n_ptr + ["int"] * n_int, name
    lookups = re.findall(r'_build\.entry\("simple_rnn", f"\{(NAME_\w+)\}_'
                         r'\{sfx\}", \*(\w+)\)', wrapper)
    assert lookups == [("NAME_FWD", "FWD_ARGS"), ("NAME_BWD", "BWD_ARGS")]
