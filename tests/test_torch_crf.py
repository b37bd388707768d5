"""The port's linear-chain CRF and CTC (``ops/crf.py``, ``ops/ctc.py``)
and their layers against the JAX package's on the CPU, on ragged
batches that include length 1.

- ``crf_log_likelihood``: the per-sequence loss and its gradients with
  respect to the emissions and the [N+2, N] weight.
- ``crf_decode``: the port's path is held by its score under JAX's
  emissions and weight against JAX's best score (the count of tags equal
  to JAX's is reported), and its own best score against JAX's; past a
  sequence's end the tags are 0.  Where every path ties, both take the
  first maximum (all tags 0), exactly.
- ``ctc_loss`` (labels with a repeat, a label of length 1 at one logit
  step) with its gradient, and ``ctc_greedy_decode`` exactly.
- The layers through both DSLs on JAX's init (``params_from_numpy``):
  ``crf_layer``, ``crf_decoding_layer`` (tags, and the error indicator
  with a label) sharing the weight through ``param_name``, ``ctc_layer``
  and ``warp_ctc_layer``; the CRF weight's key, shape and init std
  (``_winit(default_std=0.1)``); a port checkpoint of the shared weight
  loads in the JAX trainer, whose decoding then equals the port's, and
  back in the port bit for bit.

Tolerances as tests/test_torch_costs.py: losses and scores within 1e-5
of their largest entry, each gradient leaf within 1e-5 of its largest
entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optim as jax_optim
from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.ops import crf as jax_crf
from paddle_tpu.ops import ctc as jax_ctc
from paddle_tpu.trainer import SGD as JaxSGD
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data.provider import (dense_vector_sequence,
                                            integer_value_sequence)
from paddle_tpu_torch.ops import crf, ctc
from paddle_tpu_torch.optim import Momentum
from paddle_tpu_torch.trainer import SGD
from tests.test_torch_costs import GRAD_TOL, TOL, _close, check_graph

B, T, N, D = 6, 7, 5, 4
LENGTHS = np.array([7, 1, 4, 6, 2, 5], np.int32)


def _crf_inputs(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, T, N).astype(np.float32),
            r.randint(0, N, (B, T)).astype(np.int32),
            (0.5 * r.randn(N + 2, N)).astype(np.float32),
            r.randn(B).astype(np.float32))


def test_crf_log_likelihood_and_gradients_match_jax():
    em, tags, w, cot = _crf_inputs()

    def jloss(e, ww):
        return jax_crf.crf_log_likelihood(e, jnp.asarray(tags),
                                          jnp.asarray(LENGTHS), ww)
    want = jax.jit(jloss)(jnp.asarray(em), jnp.asarray(w))
    de, dw = jax.jit(jax.grad(lambda e, ww: jnp.sum(jloss(e, ww) * cot),
                              argnums=(0, 1)))(jnp.asarray(em),
                                               jnp.asarray(w))
    te = torch.tensor(em, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = crf.crf_log_likelihood(te, torch.tensor(tags),
                                 torch.tensor(LENGTHS), tw)
    _close(got.detach().numpy(), want, TOL)
    assert (got.detach().numpy() > 0).all()
    (got * torch.tensor(cot)).sum().backward()
    _close(te.grad.numpy(), de, GRAD_TOL, "d emissions")
    _close(tw.grad.numpy(), dw, GRAD_TOL, "d w")
    # no gradient reaches the emissions past a sequence's end
    mask = np.arange(T)[None, :] < LENGTHS[:, None]
    assert not te.grad.numpy()[~mask].any()


def path_score(em, tags, lengths, w):
    """A path's score in numpy: start + emissions + transitions + end
    over each sequence's valid steps."""
    out = []
    for b in range(em.shape[0]):
        n, t = int(lengths[b]), tags[b]
        s = w[0, t[0]] + w[1, t[n - 1]] + em[b, np.arange(n), t[:n]].sum()
        s += sum(w[2 + t[i - 1], t[i]] for i in range(1, n))
        out.append(s)
    return np.array(out, np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_decode_is_held_by_score(seed):
    em, _, w, _ = _crf_inputs(seed)
    jtags, jbest = jax_crf.crf_decode(jnp.asarray(em), jnp.asarray(LENGTHS),
                                      jnp.asarray(w))
    tags, best = crf.crf_decode(torch.tensor(em), torch.tensor(LENGTHS),
                                torch.tensor(w))
    assert tags.dtype == torch.int32 and tags.shape == (B, T)
    tags = tags.numpy()
    mask = np.arange(T)[None, :] < LENGTHS[:, None]
    assert not tags[~mask].any()
    # the port's path under JAX's scores reaches JAX's best score
    _close(path_score(em, tags, LENGTHS, w), np.asarray(jbest), TOL)
    _close(best.numpy(), np.asarray(jbest), TOL)
    _close(path_score(em, np.asarray(jtags), LENGTHS, w), np.asarray(jbest),
           TOL)
    equal = int((tags == np.asarray(jtags))[mask].sum())
    print(f"crf_decode seed {seed}: {equal} of {int(mask.sum())} tags "
          "equal JAX's")


def test_crf_decode_takes_the_first_maximum_on_ties():
    em = np.zeros((B, T, N), np.float32)
    w = np.zeros((N + 2, N), np.float32)
    jtags, _ = jax_crf.crf_decode(jnp.asarray(em), jnp.asarray(LENGTHS),
                                  jnp.asarray(w))
    tags, best = crf.crf_decode(torch.tensor(em), torch.tensor(LENGTHS),
                                torch.tensor(w))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
    assert not tags.any() and not best.any()


def _ctc_inputs():
    r = np.random.RandomState(5)
    c, nl = 6, 3
    logits = r.randn(B, T, c).astype(np.float32)
    # a repeat (2, 2) with room for its blank; label length 1 at one step
    labels = np.array([[1, 2, 2], [3, 0, 0], [4, 1, 0], [2, 5, 3],
                       [1, 1, 0], [5, 0, 0]], np.int32)
    label_lengths = np.array([3, 1, 2, 3, 1, 1], np.int32)
    return logits, labels, label_lengths, c, nl


@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_loss_and_gradient_match_jax(blank):
    logits, labels, label_lengths, _, _ = _ctc_inputs()
    cot = np.random.RandomState(6).randn(B).astype(np.float32)

    def jloss(x):
        return jax_ctc.ctc_loss(jax.nn.log_softmax(x, -1),
                                jnp.asarray(LENGTHS), jnp.asarray(labels),
                                jnp.asarray(label_lengths), blank=blank)
    want = jax.jit(jloss)(jnp.asarray(logits))
    dx = jax.jit(jax.grad(lambda x: jnp.sum(jloss(x) * cot)))(
        jnp.asarray(logits))
    tx = torch.tensor(logits, requires_grad=True)
    got = ctc.ctc_loss(torch.log_softmax(tx, -1), torch.tensor(LENGTHS),
                       torch.tensor(labels), torch.tensor(label_lengths),
                       blank=blank)
    _close(got.detach().numpy(), want, TOL)
    assert np.isfinite(got.detach().numpy()).all()
    (got * torch.tensor(cot)).sum().backward()
    _close(tx.grad.numpy(), dx, GRAD_TOL)


def test_ctc_greedy_decode_matches_jax():
    logits, _, _, c, _ = _ctc_inputs()
    # runs of one id, so repeats collapse
    logits[:, 2] = logits[:, 1]
    jids, jlen = jax_ctc.ctc_greedy_decode(jnp.asarray(logits),
                                           jnp.asarray(LENGTHS), blank=0)
    ids, lengths = ctc.ctc_greedy_decode(torch.tensor(logits),
                                         torch.tensor(LENGTHS), blank=0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))


# ------------------------------------------------------------ the layers

def _feed():
    r = np.random.RandomState(7)
    logits, labels, label_lengths, _, _ = _ctc_inputs()
    return {"xs": (r.randn(B, T, D).astype(np.float32), LENGTHS),
            "tags": (r.randint(0, N, (B, T)).astype(np.int32), LENGTHS),
            "lab": (labels, label_lengths)}


def _emission(M):
    return M.fc_layer(M.data_layer("xs", size=D, is_seq=True), size=N,
                      act=None)


def _tags(M):
    return M.data_layer("tags", size=N, is_seq=True)


def _crf_pair(M):
    emission = _emission(M)
    cost = M.crf_layer(emission, _tags(M), size=N, name="crf")
    return cost, emission


LAYERS = {
    "crf_layer": lambda M: _crf_pair(M)[0],
    "crf_layer_param_attr": lambda M: M.crf_layer(
        _emission(M), _tags(M), size=N,
        param_attr={"name": "crfw", "initial_std": 0.3}),
    "crf_decoding_layer": lambda M: M.crf_decoding_layer(
        _emission(M), size=N),
    "crf_decoding_layer_label": lambda M: M.crf_decoding_layer(
        _emission(M), size=N, label=_tags(M)),
    "ctc_layer": lambda M: M.ctc_layer(
        M.fc_layer(M.data_layer("xs", size=D, is_seq=True), size=6,
                   act="softmax"),
        M.data_layer("lab", size=6, is_seq=True), size=6),
    "warp_ctc_layer": lambda M: M.warp_ctc_layer(
        M.fc_layer(M.data_layer("xs", size=D, is_seq=True), size=6,
                   act=None),
        M.data_layer("lab", size=6, is_seq=True), size=6),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_structured_layer_matches_jax(case):
    got, _ = check_graph(LAYERS[case], _feed(), seed=8)
    assert got.shape[0] == B


def _shared(M):
    cost, emission = _crf_pair(M)
    decoded = M.crf_decoding_layer(emission, size=N,
                                   param_name=cost.cfg["param_name"])
    return cost, decoded


def test_crf_weight_is_shared_and_keyed_as_jax():
    jax_reset_names()
    jtopo = JL.Topology(list(_shared(JL)))
    L.reset_names()
    cost, decoded = _shared(L)
    ttopo = L.Topology([cost, decoded])
    assert ttopo.param_shapes() == {
        k: {n: tuple(a.shape) for n, a in v.items()}
        for k, v in jtopo.init(jax.random.PRNGKey(0)).items()}
    assert decoded.cfg["param_name"] == "crf"
    w = ttopo.init(torch.Generator().manual_seed(0), device="cpu")["crf"]["w"]
    assert w.shape == (N + 2, N) and 0.07 < float(w.std()) < 0.13


def test_shared_crf_weight_checkpoint_round_trip(tmp_path):
    """The port trains the shared weight one step and saves; the JAX
    trainer loads the pass dir and decodes as the port does; a fresh
    port trainer loads it bit for bit."""
    feed = _feed()
    xs, tags = feed["xs"][0], feed["tags"][0]
    batch = [(xs[b, :n], tags[b, :n]) for b, n in enumerate(LENGTHS)]
    feeding = {"xs": dense_vector_sequence(D),
               "tags": integer_value_sequence(N)}
    L.reset_names()
    cost, decoded = _shared(L)
    port = SGD(cost, update_equation=Momentum(learning_rate=0.1,
                                              momentum=0.9), device="cpu")
    port.train_one_batch(batch, feeder=feeding)
    port.save(str(tmp_path), pass_id=0)
    jax_reset_names()
    jcost, jdecoded = _shared(JL)
    jt = JaxSGD(jcost, update_equation=jax_optim.Momentum(
        learning_rate=0.1, momentum=0.9))
    jt.load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jt.parameters["crf"]["w"]),
                                  port.parameters["crf"]["w"].detach()
                                  .numpy())
    jf = {"xs": JaxSeq(jnp.asarray(xs), jnp.asarray(LENGTHS))}
    want = JL.Topology(jdecoded).apply(jt.parameters, jf, mode="test")
    with torch.no_grad():
        got = L.Topology(decoded).apply(
            port.parameters,
            {"xs": SequenceBatch(torch.tensor(xs), torch.tensor(LENGTHS))},
            mode="test")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    L.reset_names()
    again = SGD(_shared(L)[0], update_equation=Momentum(
        learning_rate=0.1, momentum=0.9), device="cpu", seed=3)
    again.load(str(tmp_path))
    for k in port.parameters:
        for n in port.parameters[k]:
            assert torch.equal(again.parameters[k][n],
                               port.parameters[k][n].detach())
