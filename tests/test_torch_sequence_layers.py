"""The port's sequence layers (``layers/api.py``: expand, seq_concat,
seq_reshape, sub_seq, seq_slice, maxid, eos, sampling_id, print, strided
last_seq / first_seq, ``AggregateLevel`` / ``ExpandLevel``) and the ops
under them (``ops/sequence.py``) against the JAX package's on the CPU.

Each layer runs in a small graph in both DSLs on JAX's init with
``tests/test_torch_elementwise.check_layer``: the output and its
lengths, and for a float output the gradients with respect to every
float input and parameter.  Ragged batches include length 1;
``seq_reshape`` takes rows whose len x d is not a multiple of the new
width, and its result must not depend on the batch's padded length;
``sub_seq`` / ``seq_slice`` run with and without starts / ends; the
strided pools run at a stride that does not divide T.
``sampling_id_layer``'s draws are PyTorch's bits, so it is held by the
frequency of its draws (within 5 binomial standard deviations of each
probability).  Pooling over nested sequences (``agg_level="seq"``)
still raises, naming ROADMAP A9·f.

Tolerances as in tests/test_torch_elementwise.py (1e-5 of the largest
entry); ids and lengths exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.ops import sequence as jax_seq_ops
import paddle_tpu.layers as JL
from paddle_tpu.layers.graph import reset_names as jax_reset_names
from paddle_tpu.utils.error import ConfigError as JaxConfigError
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.error import ConfigError
from tests.test_torch_elementwise import B, D, LENGTHS, T, check_layer

LENGTHS_B = np.array([3, 4, 1, 2, 4, 1], np.int32)


def _feed():
    r = np.random.RandomState(5)
    f = np.float32
    ids = r.randint(0, 6, (B, T)).astype(np.int32)
    ids[:, 2] = 3
    ties = r.randn(B, D).astype(f)
    ties[:, 3] = ties[:, 1] = ties.max(axis=1) + 1.0   # first max at 1
    return {
        "x": r.randn(B, D).astype(f),
        "xs": (r.randn(B, T, D).astype(f), LENGTHS),
        "bs": (r.randn(B, 4, D).astype(f), LENGTHS_B),
        "ids": (ids, LENGTHS),
        "ties": ties,
        "off": np.array([2, 0, 0, 1, 0, 3], np.int32),
        "size": np.array([3, 1, 0, 5, 2, 2], np.int32),
        "start": np.array([1, 0, 0, 2, 1, 4], np.int32),
        "end": np.array([6, 1, 3, 9, 2, 5], np.int32),
    }


def _d(M, name, size=D, seq=False):
    return M.data_layer(name, size=size, is_seq=seq)


def _xs(M):
    return M.fc_layer(_d(M, "xs", seq=True), size=D, act="tanh")


LAYERS = {
    "expand": lambda M: M.expand_layer(M.fc_layer(_d(M, "x"), size=D),
                                       expand_as=_d(M, "xs", seq=True)),
    "seq_concat": lambda M: M.seq_concat_layer(_xs(M),
                                               _d(M, "bs", seq=True)),
    "seq_reshape": lambda M: M.seq_reshape_layer(_xs(M), reshape_size=3),
    "seq_reshape_wider": lambda M: M.seq_reshape_layer(
        _d(M, "xs", seq=True), reshape_size=8),
    "sub_seq": lambda M: M.sub_seq_layer(_xs(M), offsets=_d(M, "off", 1),
                                         sizes=_d(M, "size", 1)),
    "seq_slice_starts_ends": lambda M: M.seq_slice_layer(
        _xs(M), starts=_d(M, "start", 1), ends=_d(M, "end", 1)),
    "seq_slice_starts": lambda M: M.seq_slice_layer(
        _xs(M), starts=_d(M, "start", 1)),
    "seq_slice_ends": lambda M: M.seq_slice_layer(_xs(M),
                                                  ends=_d(M, "end", 1)),
    "seq_slice_whole": lambda M: M.seq_slice_layer(_xs(M)),
    "maxid": lambda M: M.maxid_layer(_d(M, "ties")),
    "maxid_seq": lambda M: M.maxid_layer(_d(M, "xs", seq=True)),
    "eos": lambda M: M.eos_layer(_d(M, "ids", 6, seq=True), eos_id=3),
    "last_seq_stride": lambda M: M.last_seq(_xs(M), stride=3),
    "first_seq_stride": lambda M: M.first_seq(_xs(M), stride=3),
    "last_seq_stride_2": lambda M: M.last_seq(_d(M, "xs", seq=True),
                                              stride=2),
    "print": lambda M: M.print_layer(_xs(M), format="value {}"),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_sequence_layer_matches_jax(case, capsys):
    got, want = check_layer(LAYERS[case], _feed())
    if case == "maxid":
        assert (got == 1).all()
    if case == "print":
        assert capsys.readouterr().out.startswith("value ")


def test_seq_reshape_ignores_the_padded_length():
    """The same sequences padded to T and to T + 3 (garbage past each
    end) reshape to the same valid rows and lengths."""
    r = np.random.RandomState(6)
    data = r.randn(B, T, D).astype(np.float32)
    wide = r.randn(B, T + 3, D).astype(np.float32) * 100
    wide[:, :T] = data
    mask = np.arange(T + 3)[None, :] < LENGTHS[:, None]
    wide[~mask] = 1e3
    a = seq_ops.seq_reshape(SequenceBatch(torch.tensor(data),
                                          torch.tensor(LENGTHS)), 3)
    b = seq_ops.seq_reshape(SequenceBatch(torch.tensor(wide),
                                          torch.tensor(LENGTHS)), 3)
    np.testing.assert_array_equal(a.lengths.numpy(), b.lengths.numpy())
    np.testing.assert_array_equal(a.lengths.numpy(),
                                  -(-(LENGTHS * D) // 3))
    for i, n in enumerate(a.lengths.tolist()):
        np.testing.assert_array_equal(a.data[i, :n].numpy(),
                                      b.data[i, :n].numpy())
        # the tail row of a ragged chunk is zero past the valid tokens
        flat = a.data[i, :n].reshape(-1).numpy()
        assert not flat[LENGTHS[i] * D:].any()


def test_ops_match_jax():
    """The ops without a layer of their own: ``scatter_rows_to_steps``,
    ``max_id`` on ties, ``eos_check`` and the strided pool on ids."""
    f = _feed()
    xs, lengths = f["xs"]
    seq = SequenceBatch(torch.tensor(xs), torch.tensor(lengths))
    jseq = JaxSeq(jnp.asarray(xs), jnp.asarray(lengths))
    np.testing.assert_array_equal(seq_ops.scatter_rows_to_steps(seq),
                                  jax_seq_ops.scatter_rows_to_steps(jseq))
    np.testing.assert_array_equal(
        seq_ops.max_id(torch.tensor(f["ties"])).numpy(),
        np.asarray(jax_seq_ops.max_id(jnp.asarray(f["ties"]))))
    ids, _ = f["ids"]
    np.testing.assert_array_equal(
        seq_ops.eos_check(torch.tensor(ids), 3).numpy(),
        np.asarray(jax_seq_ops.eos_check(jnp.asarray(ids), 3)))
    for pool in ("first", "last"):
        got = seq_ops.seq_strided_pool(
            SequenceBatch(torch.tensor(ids), torch.tensor(lengths)), pool, 4)
        want = jax_seq_ops.seq_strided_pool(
            JaxSeq(jnp.asarray(ids), jnp.asarray(lengths)), pool, 4)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
    with pytest.raises(ValueError, match="last/first"):
        seq_ops.seq_strided_pool(seq, "max", 2)


def test_sampling_id_draws_follow_the_distribution():
    """Each row's ids drawn by the layer (4096 rows a distribution, from
    the apply's generator) land on every id at its probability within 5
    binomial standard deviations; a zero-probability id is never
    drawn."""
    probs = np.array([[0.1, 0.2, 0.3, 0.4, 0.0],
                      [0.7, 0.0, 0.1, 0.1, 0.1]], np.float32)
    n = 4096
    feed = {"p": torch.tensor(np.repeat(probs, n, axis=0))}
    L.reset_names()
    topo = L.Topology(L.sampling_id_layer(_d(L, "p", 5)))
    ids = topo.apply({}, feed, generator=torch.Generator().manual_seed(3))
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (2 * n,)
    for row, p in enumerate(probs):
        drawn = ids[row * n:(row + 1) * n].numpy()
        share = np.bincount(drawn, minlength=5) / n
        assert (np.abs(share - p) <= 5 * np.sqrt(p * (1 - p) / n)).all()
        assert not share[p == 0].any()
    # the op alone: unnormalized rows read as JAX's categorical reads them
    u = torch.tensor([0.05, 0.5, 0.95])
    got = seq_ops.sampling_id(u, torch.tensor([[2.0, 2.0, 0.0, 0.0]] * 3))
    assert got.tolist() == [0, 1, 1]
    with pytest.raises(ConfigError, match="generator"):
        topo.apply({}, feed)


def test_levels_match_jax():
    for cls in ("AggregateLevel", "ExpandLevel"):
        mine, theirs = getattr(L, cls), getattr(JL, cls)
        names = [k for k in vars(theirs) if not k.startswith("_")]
        assert names and all(getattr(mine, k) == getattr(theirs, k)
                             for k in names)


@pytest.mark.parametrize("ctor", ["pooling_layer", "last_seq", "first_seq"])
def test_seq_level_pooling_of_a_non_sequence_raises_as_jax(ctor):
    """``agg_level="seq"`` pools each sub-sequence of a nested sequence
    (``tests/test_torch_nested.py``); over a non-sequence input it raises
    ConfigError at apply, as JAX's ``as_seq`` does.  Strided pooling
    keeps a sequence (the cases above)."""
    L.reset_names()
    node = getattr(L, ctor)(_d(L, "x"), agg_level="seq")
    assert node.is_seq
    with pytest.raises(ConfigError, match="expected a sequence input"):
        L.Topology(node).apply({}, {"x": torch.ones(2, D)})
    jax_reset_names()
    jnode = getattr(JL, ctor)(_d(JL, "x"), agg_level="seq")
    with pytest.raises(JaxConfigError, match="expected a sequence input"):
        JL.Topology(jnode).apply({}, {"x": jnp.ones((2, D))})
    assert L.last_seq(_d(L, "xs", seq=True), stride=2).is_seq
    assert not L.last_seq(_d(L, "xs", seq=True)).is_seq
