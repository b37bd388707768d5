"""The ``prev_batch_state`` carry of the port's whole-sequence RNN layers
(``lstmemory``, ``grumemory``, ``recurrent_layer``) against the JAX
package's on the CPU.

``tests/test_rnn_ops.py``'s check for each layer: one long sequence cut
into two halves run as consecutive batches with the carry equals one
unbroken run, and both halves equal JAX's two carried batches (the
carried state too), from JAX's init perturbed by seeded noise; without
the carry the halves do not equal the unbroken run.  Then the refusals
(a reversed layer, a carried batch of another size), and SGD steps of a
carried classifier against JAX's trainer, after which the carried state
in ``model_state`` requires no gradient.

Tolerance: float32 on both sides in other summation orders; values
within TOL = 1e-5 of each one's largest entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.layers as JL
from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.layers.graph import value_data as jax_value
from paddle_tpu.trainer import SGD as JaxSGD
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layers.graph import value_data
from paddle_tpu_torch.trainer import SGD
from paddle_tpu_torch.utils.error import ConfigError

TOL = 1e-5
B, T, HID = 3, 8, 5
# (ctor, the input's width per unit of size, the carried state's width)
CELLS = {"lstmemory": (4, 2), "grumemory": (3, 1), "recurrent_layer": (1, 1)}


def carried(M, cell, carry=True, reverse=False):
    x = M.data_layer("x", size=CELLS[cell][0] * HID, is_seq=True)
    if cell == "recurrent_layer":
        return M.recurrent_layer(x, prev_batch_state=carry, reverse=reverse,
                                 name="rnn")
    return getattr(M, cell)(x, size=HID, prev_batch_state=carry,
                            reverse=reverse, name="rnn")


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} of {scale}"


def _jax_tree(cell, seed=0):
    jax_reset_names()
    topo = JL.Topology(carried(JL, cell))
    rng = np.random.RandomState(seed + 100)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), topo.init(jax.random.PRNGKey(seed)))
    return topo, tree


def _halves(full, lib, seq):
    mid = full.shape[1] // 2
    return [seq(lib.asarray(full[:, lo:hi]) if lib is jnp
                else torch.tensor(full[:, lo:hi]),
                lib.full((B,), hi - lo, dtype=lib.int32))
            for lo, hi in ((0, mid), (mid, full.shape[1]))]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_halves_with_the_carry_equal_one_run_and_jax(cell):
    width, state_w = CELLS[cell][0] * HID, CELLS[cell][1] * HID
    full = np.random.RandomState(1).randn(B, T, width).astype(np.float32)
    jtopo, tree = _jax_tree(cell)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jo, jst = [], [{}]
    for half in _halves(full, jnp, JaxSeq):
        o, st = jtopo.apply(jparams, {"x": half}, mode="test", state=jst[-1],
                            return_state=True)
        jo.append(np.asarray(jax_value(o)))
        jst.append(st)

    L.reset_names()
    topo = L.Topology(carried(L, cell))
    params = L.params_from_numpy(topo, tree, device="cpu")
    ref = value_data(topo.apply(params, {"x": SequenceBatch(
        torch.tensor(full), torch.full((B,), T, dtype=torch.int32))},
        mode="test"))
    outs, st = [], {}
    for i, half in enumerate(_halves(full, torch, SequenceBatch)):
        o, st = topo.apply(params, {"x": half}, mode="test", state=st,
                           return_state=True)
        outs.append(value_data(o))
        _close(outs[-1].numpy(), jo[i], f"half {i} vs JAX")
        assert set(st) == set(jst[i + 1]) == {"rnn/carry"}
        assert st["rnn/carry"].shape == (B, state_w)
        _close(st["rnn/carry"].numpy(), jst[i + 1]["rnn/carry"],
               f"carry {i}")
    _close(torch.cat(outs, 1).numpy(), ref.numpy(), "halves vs one run")

    # the control: the same halves without the carry
    L.reset_names()
    plain = L.Topology(carried(L, cell, carry=False))
    got_n = torch.cat([value_data(plain.apply(params, {"x": h},
                                              mode="test"))
                       for h in _halves(full, torch, SequenceBatch)], 1)
    err = float((got_n - ref).abs().max()) / float(ref.abs().max())
    assert err > 100 * TOL, err


def test_reverse_refused_as_jax():
    for cell in sorted(CELLS):
        L.reset_names()
        with pytest.raises(ConfigError, match="prev_batch_state cannot "
                                              "carry state for a reverse"):
            carried(L, cell, reverse=True)
        jax_reset_names()
        jtopo = JL.Topology(carried(JL, cell, reverse=True))
        full = np.zeros((B, T, CELLS[cell][0] * HID), np.float32)
        with pytest.raises(JaxConfigError, match="prev_batch_state cannot "
                                                 "carry state for a reverse"):
            jtopo.apply(jtopo.init(jax.random.PRNGKey(0)),
                        {"x": _halves(full, jnp, JaxSeq)[0]}, mode="test")


def test_carry_of_another_batch_size_refused():
    L.reset_names()
    topo = L.Topology(carried(L, "lstmemory"))
    params = topo.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(B, T, 4 * HID)
    _, st = topo.apply(params, {"x": SequenceBatch(
        x, torch.full((B,), T, dtype=torch.int32))}, return_state=True)
    with pytest.raises(ConfigError, match=f"batch {B} into a batch of 2"):
        topo.apply(params, {"x": SequenceBatch(
            x[:2], torch.full((2,), T, dtype=torch.int32))}, state=st)


V = 20


def classifier(M):
    w = M.data_layer("w", size=V, is_seq=True)
    x4 = M.fc_layer(M.embedding_layer(w, size=6), size=4 * HID, act=None,
                    bias_attr=False)
    h = M.lstmemory(x4, size=HID, prev_batch_state=True, name="carried")
    out = M.fc_layer(M.last_seq(h), size=2, act="softmax")
    return M.classification_cost(out, M.data_layer("lab", 1))


def test_sgd_steps_with_the_carry_match_jax_and_carry_no_grad():
    rng = np.random.RandomState(7)
    batches = [[(rng.randint(0, V, n).tolist(), int(rng.randint(2)))
                for n in [T] + list(rng.randint(1, T + 1, B - 1))]
               for _ in range(3)]
    from paddle_tpu.data import integer_value as ji, \
        integer_value_sequence as jis
    from paddle_tpu_torch.data import DataFeeder, integer_value, \
        integer_value_sequence
    jax_reset_names()
    jt = JaxSGD(classifier(JL), update_equation=jax_optim.Momentum(
        learning_rate=0.1, momentum=0.9), seed=3, donate=False)
    start = jax.tree_util.tree_map(np.asarray, jt.parameters)
    want = [float(jt.train_one_batch(b, feeder={"w": jis(V), "lab": ji(2)}))
            for b in batches]
    L.reset_names()
    tr = SGD(classifier(L), parameters=start, update_equation=optim.Momentum(
        learning_rate=0.1, momentum=0.9), device="cpu")
    feeder = DataFeeder({"w": integer_value_sequence(V),
                         "lab": integer_value(2)}, device="cpu")
    got = []
    for b in batches:
        got.append(float(tr.train_one_batch(b, feeder)))
        carry = tr.model_state["carried/carry"]
        assert not carry.requires_grad and carry.grad_fn is None
    np.testing.assert_allclose(got, want, rtol=TOL)
    _close(tr.model_state["carried/carry"].numpy(),
           jt.model_state["carried/carry"], "carry after 3 steps")
