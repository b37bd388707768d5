"""The MT model's beam decoders and the seq2seq beam ``generate`` of the
port against the JAX package's, on the CPU.

The MT model is tests/test_transformer_decode.py's (vocab 60, d 32, 4
heads, 2 + 2 layers, B 3 ragged sources of up to 9 tokens, max_len 12)
on JAX's initial weights: ``decode_step_cached`` against column t of
the port's full ``decode`` and of JAX's step, ``generate_cached``
against the port's ``generate`` (the full-recompute oracle) and against
JAX's ``generate_cached`` run live (not tests/test_generation_golden.py's
``GOLDEN_BEAM``), and the ``max_len`` refusal.  The seq2seq model runs
at a width where JAX's fused GRU route holds (vocab 40, emb = h = 128,
B 8, sources of up to 6 tokens), JAX's route forced so that its Pallas
GRU runs in interpret mode.  Each JAX reference is computed once for the
module.

Tolerances: float32 on both sides, in other summation orders.  Logits
are held as tests/test_transformer_decode.py holds the cached step to
the full decode (2e-4 relative and absolute); beam tokens and lengths
must be equal and scores within 1e-5 relative (a log-softmax sum over 12
steps of values of order 1-10).  Every case checks that its smallest
top-K / top-(K+1) candidate gap along the search (the port's ``trace``)
is at least ``GAP_MIN``, ten times the largest score difference the two
packages show here (3.8e-6, the seq2seq case), so that no near-tie
makes equal tokens a matter of rounding.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.models import seq2seq as jax_seq2seq
from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops import rnn as jax_rnn
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.models import seq2seq, transformer

VOCAB, D, HEADS, LAYERS, MAX_LEN, SRC_LEN, B = 60, 32, 4, 2, 12, 9, 3
RTOL = 2e-4
SCORE_RTOL = 1e-5
GAP_MIN = 5e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _mt():
    """(numpy params, source ids, lengths) of the module's MT model."""
    params = jax_tf.init(jax.random.PRNGKey(0), src_vocab=VOCAB,
                         trg_vocab=VOCAB, d_model=D, dff=64,
                         enc_layers=LAYERS, dec_layers=LAYERS,
                         max_len=MAX_LEN + SRC_LEN)
    rng = np.random.RandomState(1)
    ids = rng.randint(3, VOCAB, (B, SRC_LEN)).astype(np.int32)
    lengths = rng.randint(3, SRC_LEN + 1, (B,)).astype(np.int32)
    return _host(params), ids, lengths


def _jax_src():
    _, ids, lengths = _mt()
    return JaxSeq(jnp.asarray(ids), jnp.asarray(lengths))


def _src():
    _, ids, lengths = _mt()
    return SequenceBatch(torch.tensor(ids), torch.tensor(lengths))


def _port_params():
    return transformer.params_from_numpy(_mt()[0], device="cpu")


def _result(res):
    return {f: (getattr(res, f).numpy() if isinstance(getattr(res, f),
                                                      torch.Tensor)
                else np.asarray(getattr(res, f))) for f in res._fields}


def _same_beams(got, want):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=SCORE_RTOL, atol=SCORE_RTOL)


def _min_gap(trace):
    return float(min(float(step["gap"].min()) for step in trace))


@functools.lru_cache(maxsize=None)
def _jax_generate_cached(beam_size, length_penalty):
    params = jax.tree_util.tree_map(jnp.asarray, _mt()[0])
    return _result(jax_tf.generate_cached(
        params, _jax_src(), beam_size=beam_size, max_len=MAX_LEN,
        num_heads=HEADS, length_penalty=length_penalty))


def test_decode_step_cached_is_column_t_of_decode():
    """Each cached step's logits against column t of the port's full
    decode over the same prefix and against JAX's cached step."""
    params = _port_params()
    src = _src()
    rng = np.random.RandomState(2)
    trg = rng.randint(3, VOCAB, (B, MAX_LEN)).astype(np.int32)
    enc = transformer.encode(params, src, HEADS)
    full = transformer.decode(
        params, enc, src.mask(),
        SequenceBatch(torch.tensor(trg), torch.full((B,), MAX_LEN)), HEADS)
    cache = transformer.init_decode_cache(params, enc, MAX_LEN)
    cross = transformer.cross_kv(params, enc)
    jp = jax.tree_util.tree_map(jnp.asarray, _mt()[0])
    jenc = jax_tf.encode(jp, _jax_src(), HEADS)
    jcache = jax_tf.init_decode_cache(jp, jenc, MAX_LEN)
    jcross = jax_tf.cross_kv(jp, jenc)
    for t in range(MAX_LEN):
        logits, cache = transformer.decode_step_cached(
            params, src.mask(), torch.tensor(trg[:, t]), t, cache, cross,
            HEADS)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=RTOL, atol=RTOL)
        jlogits, jcache = jax_tf.decode_step_cached(
            jp, _jax_src().mask(), jnp.asarray(trg[:, t]), jnp.int32(t),
            jcache, jcross, HEADS)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("beam_size, length_penalty", [(3, 0.6), (4, 0.0)])
def test_generate_cached_matches_generate_and_jax(beam_size, length_penalty):
    params = _port_params()
    trace = []
    cached = _result(transformer.generate_cached(
        params, _src(), beam_size=beam_size, max_len=MAX_LEN,
        num_heads=HEADS, length_penalty=length_penalty, trace=trace))
    assert len(trace) == MAX_LEN and _min_gap(trace) >= GAP_MIN
    full = _result(transformer.generate(
        params, _src(), beam_size=beam_size, max_len=MAX_LEN,
        num_heads=HEADS, length_penalty=length_penalty))
    _same_beams(cached, full)
    _same_beams(cached, _jax_generate_cached(beam_size, length_penalty))
    assert cached["tokens"].shape == (B, beam_size, MAX_LEN)


def test_generate_cached_runs_without_autograd():
    """Parameters that require gradients still decode without a graph."""
    params = _port_params()
    for leaf in (params["out"], params["trg_emb"]):
        leaf.requires_grad_(True)
    res = transformer.generate_cached(params, _src(), beam_size=2,
                                      max_len=4, num_heads=HEADS)
    assert not res.scores.requires_grad


def test_cached_decode_rejects_an_overlong_max_len():
    params = _port_params()
    with pytest.raises(ValueError, match="positional table"):
        transformer.generate_cached(params, _src(), beam_size=2,
                                    max_len=10_000, num_heads=HEADS)
    with pytest.raises(ValueError, match="positional table"):
        jax_tf.generate_cached(jax.tree_util.tree_map(jnp.asarray,
                                                      _mt()[0]),
                               _jax_src(), beam_size=2, max_len=10_000,
                               num_heads=HEADS)


# ---------------------------------------------------------------- seq2seq

S_VOCAB, S_H, S_B, S_TS, S_BEAM, S_MAX = 40, 128, 8, 6, 3, 6
S_LEN = np.asarray([6, 6, 3, 6, 1, 6, 5, 6], np.int32)


@functools.lru_cache(maxsize=None)
def _seq2seq():
    """(numpy params, source ids, JAX's beam result with its fused GRU
    route forced)."""
    params = jax_seq2seq.init(jax.random.PRNGKey(3), src_vocab=S_VOCAB,
                              trg_vocab=S_VOCAB, emb_dim=S_H, hidden=S_H)
    ids = np.random.RandomState(4).randint(
        2, S_VOCAB, (S_B, S_TS)).astype(np.int32)
    prior = jax_rnn.FUSED_LSTM
    jax_rnn.FUSED_LSTM = "always"
    try:
        count = jax_rnn.FUSED_DISPATCH_COUNT
        res = jax_seq2seq.generate(params, JaxSeq(jnp.asarray(ids),
                                                  jnp.asarray(S_LEN)),
                                   beam_size=S_BEAM, max_len=S_MAX)
        assert jax_rnn.FUSED_DISPATCH_COUNT - count == 2
    finally:
        jax_rnn.FUSED_LSTM = prior
    return _host(params), ids, _result(res)


def test_seq2seq_generate_matches_jax():
    params_np, ids, want = _seq2seq()
    params = seq2seq.params_from_numpy(params_np, device="cpu")
    trace = []
    got = _result(seq2seq.generate(
        params, SequenceBatch(torch.tensor(ids), torch.tensor(S_LEN)),
        beam_size=S_BEAM, max_len=S_MAX, trace=trace))
    assert _min_gap(trace) >= GAP_MIN
    _same_beams(got, want)
    assert got["tokens"].shape == (S_B, S_BEAM, S_MAX)
