"""``ops/beam.beam_search`` of the port against the JAX package's on the
cases of tests/test_beam.py (the brute-force optimum, eos freezing, the
drop callback's bans and prefix) plus ``candidate_adjust``,
``length_penalty``, a state the step reads (so the lane reordering is
held), exact ties among live candidates and steps where fewer than K
lanes are live (many candidates tie at -1e30).  Both packages run the
same float32 arithmetic on the same tables: tokens and lengths must be
equal, scores within 1e-6 (relative, 1e-6 absolute near zero: the
length penalty's power may round an ulp apart).  The ties are broken
lowest flat index first in both (``lax.top_k``; the port's stable
sort)."""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import beam as jax_beam
from paddle_tpu_torch.ops import beam


def _log_softmax(x):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x, jnp.float32),
                                         axis=-1))


def _steps(trans):
    """(jax step_fn, torch step_fn) of a fixed transition table [V, V]."""
    tj, tt = jnp.asarray(trans), torch.tensor(trans)

    def jstep(state, prev):
        return tj[prev], state

    def tstep(state, prev):
        return tt[prev.long()], state
    return jstep, tstep


def _run(jstep, tstep, batch, beam_size, max_len, bos, eos, init=None,
         jax_kw=None, torch_kw=None, **kw):
    """Both packages' results on the same search, as numpy."""
    init = np.zeros((batch * beam_size, 1), np.float32) if init is None \
        else init
    want = jax_beam.beam_search(jstep, jnp.asarray(init), batch, beam_size,
                                max_len, bos, eos, **kw, **(jax_kw or {}))
    got = beam.beam_search(tstep, torch.tensor(init), batch, beam_size,
                           max_len, bos, eos, **kw, **(torch_kw or {}))
    return ({f: np.asarray(getattr(want, f)) for f in want._fields},
            {f: getattr(got, f).numpy() for f in got._fields})


def _same(want, got):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["tokens"].dtype == np.int32
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6,
                               atol=1e-6)


def _brute_best(trans, bos, eos, max_len):
    v = trans.shape[0]
    best, best_seq = -np.inf, None
    for seq in itertools.product(range(v), repeat=max_len):
        score, prev, length = 0.0, bos, 0
        for s in seq:
            score += trans[prev, s]
            prev = s
            length += 1
            if s == eos:
                break
        if score > best:
            best, best_seq = score, seq[:length]
    return best, best_seq


def test_beam_finds_the_brute_force_optimum(np_rng):
    trans = _log_softmax(np_rng.randn(5, 5))
    want, got = _run(*_steps(trans), 1, 8, 4, 0, 1)
    _same(want, got)
    best, best_seq = _brute_best(trans, 0, 1, 4)
    np.testing.assert_allclose(got["scores"][0, 0], best, rtol=1e-4)
    assert list(got["tokens"][0, 0, :len(best_seq)]) == list(best_seq)


def test_eos_freezes_the_score():
    trans = np.full((4, 4), -10.0, np.float32)
    trans[:, 1] = -0.1
    want, got = _run(*_steps(trans), 1, 3, 6, 0, 1)
    _same(want, got)
    np.testing.assert_allclose(got["scores"][0, 0], -0.1, rtol=1e-5)
    assert got["lengths"][0, 0] == 0


def test_drop_callback_bans_a_token(np_rng):
    trans = _log_softmax(np_rng.randn(5, 5))

    def jdrop(tokens, t, cand):
        return cand.at[..., 3].set(-1e30)

    def tdrop(tokens, t, cand):
        cand = cand.clone()
        cand[..., 3] = -1e30
        return cand

    want, got = _run(*_steps(trans), 1, 8, 4, 0, 1,
                     jax_kw={"drop_callback": jdrop},
                     torch_kw={"drop_callback": tdrop})
    _same(want, got)
    for k in range(8):
        assert 3 not in got["tokens"][0, k, :got["lengths"][0, k]]


def test_drop_callback_sees_the_prefix(np_rng):
    logits = np_rng.randn(6, 6).astype(np.float32)
    logits[np.arange(6), np.arange(6)] += 3.0
    trans = _log_softmax(logits)

    def jdrop(tokens, t, cand):
        prev = jnp.where(t > 0, tokens[:, :, jnp.maximum(t - 1, 0)], -1)
        return jnp.where(jax.nn.one_hot(prev, 6, dtype=bool), -1e30, cand)

    def tdrop(tokens, t, cand):
        if t == 0:
            return cand
        ban = torch.nn.functional.one_hot(tokens[:, :, t - 1].long(), 6)
        return torch.where(ban.bool(), torch.tensor(-1e30), cand)

    want, got = _run(*_steps(trans), 2, 4, 5, 1, 0,
                     jax_kw={"drop_callback": jdrop},
                     torch_kw={"drop_callback": tdrop})
    _same(want, got)
    for b, k in itertools.product(range(2), range(4)):
        seq = got["tokens"][b, k, :got["lengths"][b, k]]
        assert all(seq[i] != seq[i + 1] for i in range(len(seq) - 1))


def test_candidate_adjust(np_rng):
    trans = _log_softmax(np_rng.randn(7, 7))
    pen = np.zeros(7, np.float32)
    pen[[2, 4]] = 1.5
    want, got = _run(*_steps(trans), 3, 3, 6, 0, 1,
                     jax_kw={"candidate_adjust":
                             lambda lp: lp - jnp.asarray(pen)},
                     torch_kw={"candidate_adjust":
                               lambda lp: lp - torch.tensor(pen)})
    _same(want, got)


@pytest.mark.parametrize("penalty", [0.6, 1.0])
def test_length_penalty(np_rng, penalty):
    logits = np_rng.randn(6, 6).astype(np.float32)
    logits[:, 1] += 1.0          # eos likely: lanes of several lengths
    trans = _log_softmax(logits)
    want, got = _run(*_steps(trans), 4, 4, 7, 0, 1, length_penalty=penalty)
    _same(want, got)
    assert len(np.unique(got["lengths"])) > 1


def test_stateful_step_reorders_the_state(np_rng):
    """The step reads its state (each lane's running token sum, a state
    leaf [B*K, 1], and a second leaf in a dict), so a wrong lane gather
    changes the search."""
    v = 9
    base = np_rng.randn(v, v).astype(np.float32)
    mix = np_rng.randn(v, v).astype(np.float32)

    def jstep(state, prev):
        acc = state["acc"] + prev[:, None].astype(jnp.float32)
        idx = (acc[:, 0].astype(jnp.int32)) % v
        lp = jax.nn.log_softmax(jnp.asarray(base)[prev]
                                + jnp.asarray(mix)[idx], axis=-1)
        return lp, {"acc": acc, "n": state["n"] + 1}

    def tstep(state, prev):
        acc = state["acc"] + prev[:, None].float()
        idx = acc[:, 0].to(torch.int32).long() % v
        lp = torch.log_softmax(torch.tensor(base)[prev.long()]
                               + torch.tensor(mix)[idx], dim=-1)
        return lp, {"acc": acc, "n": state["n"] + 1}

    b, k = 3, 4
    init = {"acc": np.zeros((b * k, 1), np.float32),
            "n": np.zeros((b * k,), np.int32)}
    want = jax_beam.beam_search(
        jstep, {n: jnp.asarray(a) for n, a in init.items()}, b, k, 6, 0, 1)
    got = beam.beam_search(
        tstep, {n: torch.tensor(a) for n, a in init.items()}, b, k, 6, 0, 1)
    _same({f: np.asarray(getattr(want, f)) for f in want._fields},
          {f: getattr(got, f).numpy() for f in got._fields})


def test_ties_break_lowest_index_first():
    """Every transition equally likely: every live candidate ties, so the
    survivors are the lowest flat indices (lane-major, then token), and
    eos finishes lanes while fewer than K are live."""
    v = 5
    trans = np.full((v, v), -np.log(v), np.float32)
    want, got = _run(*_steps(trans), 2, 4, 5, 0, 1)
    _same(want, got)


def test_fewer_live_lanes_than_k_tie_at_the_floor():
    """eos dominates from bos, so after step 0 every lane but few is
    finished: their candidates other than eos sit at -1e30 + score ==
    -1e30 in float32 and tie; the lowest flat index decides which lanes
    survive, their lengths and the state gather."""
    v = 6
    logits = np.full((v, v), -4.0, np.float32)
    logits[:, 1] = 3.0
    logits[0, 2] = 2.9
    trans = _log_softmax(logits)
    trace = []
    want, got = _run(*_steps(trans), 3, 5, 4, 0, 1,
                     torch_kw={"trace": trace})
    _same(want, got)
    # the trace marks the dead-lane ties as no near-tie (gap +inf)
    assert len(trace) == 4 and bool(torch.isinf(trace[-1]["gap"]).all())
