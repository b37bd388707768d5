"""The port's packed-row training, ``remat`` and ``sequence_softmax``
(``models/transformer.encode`` / ``lm_logits`` / ``lm_loss`` with
``segment_ids`` / ``positions``, ``remat=True`` in ``encode`` / ``decode``,
``ops/activations.sequence_softmax``) against the JAX package on the CPU,
on the same weights (``params_from_numpy``) and inputs from a seed.

Config: vocab 50, d_model 32, 2 heads, dff 64, 2 layers; packed rows of
24 slots from the port's ``pack_sequences`` (held equal to JAX's); the
remat cases at T 128 with ``full_seq`` (the flash route: on the CPU
``FlashAttention``'s plain halves).  Tolerances: float32 on both sides,
sums in other orders — losses at rtol 1e-5, hidden states, logits and
every gradient leaf within 1e-5 of their largest magnitude (an element
near 0 carries its larger summands' rounding).  ``remat=True`` against
``remat=False`` in the port is bit for bit: the same kernels re-run on
the same inputs.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxBatch
from paddle_tpu.core.sequence import pack_sequences as jax_pack
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops import activations as jax_act
from paddle_tpu_torch.core.sequence import SequenceBatch, pack_sequences
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.utils.tree import tree_leaves

VOCAB, D_MODEL, HEADS, DFF, LAYERS, SLOTS, MAX_LEN = 50, 32, 2, 64, 2, 24, 32
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5


def _trunk(pos_type):
    jp = jax_tf.init(jax.random.PRNGKey(6), src_vocab=VOCAB, trg_vocab=1,
                     d_model=D_MODEL, num_heads=HEADS, dff=DFF,
                     enc_layers=LAYERS, dec_layers=0, max_len=MAX_LEN,
                     pos_type=pos_type)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def trunks():
    return {pt: _trunk(pt) for pt in ("learned", "rope")}


def _port(tree):
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return tp


def _grads(tp):
    out = [p.grad.clone() for p in tree_leaves(tp)]
    for p in tree_leaves(tp):
        p.grad = None
    return out


def _close_grads(got, want_tree, keys):
    want = jax.tree_util.tree_leaves(
        {k: v for k, v in want_tree.items() if k in keys})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()


@pytest.fixture(scope="module")
def packed():
    """One packing of ragged sequences, as both packages see it."""
    rng = np.random.RandomState(11)
    seqs = [rng.randint(3, VOCAB, n) for n in (9, 5, 14, 3, 7, 11, 4, 20, 2)]
    data, seg, pos = pack_sequences(seqs, SLOTS)
    for got, want in zip((data, seg, pos), jax_pack(seqs, SLOTS)):
        np.testing.assert_array_equal(got, want)
    lengths = np.full((data.shape[0],), SLOTS, np.int32)
    return ((JaxBatch(jnp.asarray(data), jnp.asarray(lengths)),
             jnp.asarray(seg), jnp.asarray(pos)),
            (SequenceBatch(torch.tensor(data), torch.tensor(lengths)),
             torch.tensor(seg), torch.tensor(pos)))


@pytest.mark.parametrize("pos_type", ["learned", "rope"])
def test_packed_encode_logits_and_loss_match_jax(trunks, packed, pos_type):
    """encode (causal), lm_logits and lm_loss over packed rows: the
    hidden states, the logits, the loss (labels within a segment only)
    and every gradient leaf."""
    jp, tree = trunks[pos_type]
    (jtok, jseg, jpos), (ttok, tseg, tpos) = packed
    kw = dict(pos_type=pos_type)
    jh = jax_tf.encode(jp, jtok, HEADS, causal=True, segment_ids=jseg,
                       positions=jpos, **kw)
    jlog = jax_tf.lm_logits(jp, jtok, HEADS, segment_ids=jseg,
                            positions=jpos, **kw)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_tf.lm_loss(
        p, jtok, HEADS, segment_ids=jseg, positions=jpos, **kw)))(jp)
    tp = _port(tree)
    with torch.no_grad():
        h = torch_tf.encode(tp, ttok, HEADS, causal=True, segment_ids=tseg,
                            positions=tpos, **kw)
        logits = torch_tf.lm_logits(tp, ttok, HEADS, segment_ids=tseg,
                                    positions=tpos, **kw)
    # the residual stream adds O(1) terms: an element near 0 carries the
    # rounding of its larger summands, so each is held within RTOL of
    # its array's largest magnitude
    for got, want in ((h, jh), (logits, jlog)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()
    loss = torch_tf.lm_loss(tp, ttok, HEADS, segment_ids=tseg,
                            positions=tpos, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    _close_grads(_grads(tp), jg, tp)


def test_packed_segments_are_isolated(trunks, packed):
    """Each packed segment's hidden states equal those of the segment run
    alone: the block-diagonal attention and within-segment positions."""
    _jp, tree = trunks["learned"]
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    _, (ttok, tseg, tpos) = packed
    h = torch_tf.encode(tp, ttok, HEADS, causal=True, segment_ids=tseg,
                        positions=tpos)
    row, label = 0, 2
    cols = (tseg[row] == label).nonzero()[:, 0]
    alone = ttok.data[row, cols][None]
    ha = torch_tf.encode(tp, SequenceBatch(alone, torch.tensor(
        [alone.shape[1]], dtype=torch.int32)), HEADS, causal=True)
    np.testing.assert_allclose(h[row, cols].detach().numpy(),
                               ha[0].detach().numpy(), rtol=RTOL, atol=ATOL)


def test_packed_refusals_mirror_jax(trunks, packed):
    """A lone segment_ids or positions is JAX's ValueError; a position
    past the learned table raises in both; mesh and zigzag still raise,
    naming ROADMAP A12."""
    jp, tree = trunks["learned"]
    (jtok, jseg, jpos), (ttok, tseg, tpos) = packed
    tp = torch_tf.params_from_numpy(tree, device="cpu")
    for jkw, tkw in ((dict(segment_ids=jseg), dict(segment_ids=tseg)),
                     (dict(positions=jpos), dict(positions=tpos))):
        with pytest.raises(ValueError, match="BOTH"):
            jax_tf.lm_loss(jp, jtok, HEADS, **jkw)
        with pytest.raises(ValueError, match="BOTH"):
            torch_tf.lm_loss(tp, ttok, HEADS, **tkw)
    with pytest.raises(ValueError, match="positional table"):
        jax_tf.encode(jp, jtok, HEADS, segment_ids=jseg,
                      positions=jpos + MAX_LEN)
    with pytest.raises(ValueError, match="positional table"):
        torch_tf.encode(tp, ttok, HEADS, segment_ids=tseg,
                        positions=tpos + MAX_LEN)
    for kw in (dict(mesh=object()), dict(zigzag=True)):
        with pytest.raises(NotImplementedError, match="A12"):
            torch_tf.lm_loss(tp, ttok, HEADS, segment_ids=tseg,
                             positions=tpos, **kw)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts FlashAttention.apply calls (the CPU counters cannot)."""
    calls = []
    real = fk.FlashAttention.apply

    def counted(*args):
        calls.append(args[4])
        return real(*args)
    monkeypatch.setattr(fk.FlashAttention, "apply", counted)
    return calls


def _full(ids):
    lengths = np.full((ids.shape[0],), ids.shape[1], np.int32)
    return (JaxBatch(jnp.asarray(ids), jnp.asarray(lengths)),
            SequenceBatch(torch.tensor(ids), torch.tensor(lengths)))


def test_mt_loss_under_remat_is_bit_for_bit_and_matches_jax(flash_calls):
    """The MT loss at T 128, full_seq (the flash route): remat=True's
    loss and gradients equal remat=False's bit for bit, each block's
    forward runs again in the backward (the flash forward twice per
    attention, its backward once), and both match JAX's remat=True."""
    jp = jax_tf.init(jax.random.PRNGKey(8), src_vocab=VOCAB, trg_vocab=VOCAB,
                     d_model=D_MODEL, num_heads=HEADS, dff=DFF, enc_layers=1,
                     dec_layers=1, max_len=128)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.RandomState(9)
    jsrc, tsrc = _full(rng.randint(3, VOCAB, (2, 128)).astype(np.int32))
    jtrg, ttrg = _full(rng.randint(3, VOCAB, (2, 128)).astype(np.int32))
    # the batches as arguments: traced lengths skip the eager full_seq
    # check, which jit could not run on closed-over constants
    jl, jg = jax.jit(jax.value_and_grad(lambda p, s, t: jax_tf.loss(
        p, s, t, t, HEADS, remat=True, full_seq=True)))(jp, jsrc, jtrg)
    tp = _port(tree)
    runs = {}
    for remat in (False, True):
        del flash_calls[:]
        loss = torch_tf.loss(tp, tsrc, ttrg, ttrg, HEADS, remat=remat,
                             full_seq=True)
        forward_calls = len(flash_calls)
        loss.backward()
        runs[remat] = (loss.detach(), _grads(tp), forward_calls,
                       len(flash_calls))
    # 3 attentions (encoder self, decoder self and cross), each once in
    # the forward; under remat each again in the backward
    assert runs[False][2:] == (3, 3) and runs[True][2:] == (3, 6)
    assert torch.equal(runs[True][0], runs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))
    np.testing.assert_allclose(float(runs[True][0]), float(jl), rtol=RTOL)
    _close_grads(runs[True][1], jg, tp)


@pytest.mark.parametrize("layout", ["packed", "padded"])
def test_lm_loss_under_remat_is_bit_for_bit_and_matches_jax(trunks, packed,
                                                            layout):
    """lm_loss with remat over packed rows (the segmented dense path) and
    over ragged rows (the key-masked dense path): bit for bit the port's
    remat=False, within tolerance of JAX's remat=True."""
    jp, tree = trunks["rope"]
    if layout == "packed":
        (jtok, jseg, jpos), (ttok, tseg, tpos) = packed
        jkw = dict(segment_ids=jseg, positions=jpos)
        tkw = dict(segment_ids=tseg, positions=tpos)
    else:
        rng = np.random.RandomState(12)
        ids = rng.randint(3, VOCAB, (3, SLOTS)).astype(np.int32)
        lengths = np.asarray([SLOTS, 17, 5], np.int32)
        jtok = JaxBatch(jnp.asarray(ids), jnp.asarray(lengths))
        ttok = SequenceBatch(torch.tensor(ids), torch.tensor(lengths))
        jkw, tkw = {}, {}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_tf.lm_loss(
        p, jtok, HEADS, remat=True, pos_type="rope", **jkw)))(jp)
    tp = _port(tree)
    runs = {}
    for remat in (False, True):
        loss = torch_tf.lm_loss(tp, ttok, HEADS, remat=remat,
                                pos_type="rope", **tkw)
        loss.backward()
        runs[remat] = (loss.detach(), _grads(tp))
    assert torch.equal(runs[True][0], runs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))
    np.testing.assert_allclose(float(runs[True][0]), float(jl), rtol=RTOL)
    _close_grads(runs[True][1], jg, tp)


def test_sequence_softmax_matches_jax(np_rng):
    """[B, T] and [B, T, 1] against JAX: padding exactly 0, an
    all-padding row all 0 (not NaN)."""
    x = np_rng.randn(4, 9).astype(np.float32) * 3
    mask = np.ones((4, 9), np.int32)
    mask[1, 5:] = 0
    mask[2, 1:] = 0
    mask[3] = 0
    want = np.asarray(jax_act.sequence_softmax(jnp.asarray(x),
                                               jnp.asarray(mask)))
    got = activations.sequence_softmax(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got.numpy()[mask == 0] == 0).all() and not torch.isnan(got).any()
    np.testing.assert_allclose(got.sum(-1).numpy(), [1, 1, 1, 0], rtol=RTOL)
    want3 = np.asarray(jax_act.sequence_softmax(jnp.asarray(x[..., None]),
                                                jnp.asarray(mask)))
    got3 = activations.sequence_softmax(torch.tensor(x[..., None]),
                                        torch.tensor(mask))
    assert got3.shape == (4, 9, 1)
    np.testing.assert_allclose(got3.numpy(), want3, rtol=RTOL, atol=ATOL)
