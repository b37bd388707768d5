"""The port's ``mixed_layer`` with every projection and operator against
the JAX package's on the CPU, in both of its protocols (``input=`` and
the ``with mixed_layer() as m: m += ...`` block), and
``networks.sequence_conv_pool``.

- Each part on JAX's init carried across (``params_from_numpy``): the
  mixed layer's output and every parameter's gradient of its mean, on
  dense rows, ragged sequences (lengths 1-7) and 6x6 images: full
  matrix, transposed full matrix, identity (whole and offset), table,
  slice, dot-mul, scaling, context (zeros out of range; trainable head
  and tail rows on sequences shorter than the window), the dot-mul
  operator, ``conv_projection`` (groups 1 and 2) and ``conv_operator``,
  and a sum of several parts with a bias and an activation.
- ROADMAP C15: JAX never runs its own width check
  (``_MixedImpl.infer``), so the sequence_tagging demo's 224-wide mixed
  layer over a 192-wide context part and a 32-wide identity part fails
  only at apply (pinned here); the port raises ``ConfigError`` at config
  time, in both protocols.  The refusals both packages share: an empty
  ``with`` block and ``+=`` after it.
- ROADMAP C14: JAX's ``sequence_conv_pool`` puts the window into a
  ``hidden_size`` mixed layer with no weight, which fails at apply
  (pinned); the port's builds the reference's network, held against the
  same network built by hand in the JAX DSL (``mixed_layer`` with
  ``context_projection``, ``fc_layer``, ``pooling_layer``).

Tolerances as tests/test_torch_costs.py: outputs within 1e-5 of their
largest entry, each gradient leaf within 1e-5 of its largest entry.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from paddle_tpu.core.sequence import SequenceBatch as JaxSeq
from paddle_tpu.layers.graph import reset_names as jax_reset_names
import paddle_tpu.layers as JL
import paddle_tpu_torch.layers as L
from paddle_tpu_torch.utils.error import ConfigError
from tests.test_torch_costs import LENGTHS, check_graph

B, T, D, V = 6, 7, 5, 11
IMG_C, IMG_HW, NF = 2, 6, 4
CONV_OUT = NF * IMG_HW * IMG_HW


def _feed():
    r = np.random.RandomState(3)
    f = np.float32
    return {
        "x": r.randn(B, D).astype(f), "y": r.randn(B, D).astype(f),
        "xs": (r.randn(B, T, D).astype(f), LENGTHS),
        "ids": (r.randint(0, V, (B, T)).astype(np.int32), LENGTHS),
        "img": r.randn(B, IMG_C * IMG_HW * IMG_HW).astype(f),
        "filt": r.randn(B, D).astype(f),
    }


def _img(M):
    return M.data_layer("img", size=IMG_C * IMG_HW * IMG_HW,
                        height=IMG_HW, width=IMG_HW)


def _fc(M, name, size, seq=False):
    return M.fc_layer(M.data_layer(name, size=D, is_seq=seq), size=size,
                      act="tanh")


# case -> (mixed size, parts(M), mixed kwargs)
PARTS = {
    "full_matrix": (4, lambda M: [M.full_matrix_projection(
        M.data_layer("x", size=D))], {}),
    "full_matrix_seq": (4, lambda M: [M.full_matrix_projection(
        M.data_layer("xs", size=D, is_seq=True))], {}),
    "trans_full_matrix": (4, lambda M: [M.trans_full_matrix_projection(
        M.data_layer("x", size=D))], {}),
    "identity": (3, lambda M: [M.identity_projection(_fc(M, "x", 3))], {}),
    "identity_offset": (3, lambda M: [M.identity_projection(
        _fc(M, "x", 6), offset=2, size=3)], {}),
    "table": (4, lambda M: [M.table_projection(
        M.data_layer("ids", size=V, is_seq=True))], {}),
    "slice": (0, lambda M: [M.slice_projection(_fc(M, "x", 6),
                                               [(0, 2), (3, 5)])], {}),
    "dotmul": (4, lambda M: [M.dotmul_projection(_fc(M, "x", 4))], {}),
    "scaling": (4, lambda M: [M.scaling_projection(_fc(M, "x", 4))], {}),
    "context": (3 * D, lambda M: [M.context_projection(
        _fc(M, "xs", D, seq=True), context_len=3, context_start=-1)], {}),
    "context_default_start": (4 * D, lambda M: [M.context_projection(
        _fc(M, "xs", D, seq=True), context_len=4)], {}),
    "context_padding": (4 * D, lambda M: [M.context_projection(
        _fc(M, "xs", D, seq=True), context_len=4, context_start=-2,
        padding_attr=True)], {}),
    "context_padding_tail": (3 * D, lambda M: [M.context_projection(
        _fc(M, "xs", D, seq=True), context_len=3, context_start=0,
        padding_attr={"initial_std": 0.5})], {}),
    "dotmul_operator": (4, lambda M: [M.dotmul_operator(
        _fc(M, "x", 4), _fc(M, "y", 4), scale=0.5)], {}),
    "conv_projection": (CONV_OUT, lambda M: [M.conv_projection(
        _img(M), filter_size=3, num_filters=NF, num_channels=IMG_C,
        padding=1)], {}),
    "conv_projection_groups": (CONV_OUT, lambda M: [M.conv_projection(
        _img(M), filter_size=3, num_filters=NF, num_channels=IMG_C,
        padding=1, groups=2)], {}),
    "conv_operator": (CONV_OUT, lambda M: [M.conv_operator(
        _img(M), M.fc_layer(M.data_layer("filt", size=D),
                            size=NF * IMG_C * 9, act=None),
        filter_size=3, num_filters=NF, num_channels=IMG_C, padding=1)], {}),
    "sum_bias_act": (4, lambda M: [
        M.full_matrix_projection(M.data_layer("x", size=D)),
        M.dotmul_projection(_fc(M, "y", 4)),
        _fc(M, "x", 4)], {"bias_attr": True, "act": "sigmoid"}),
}


def _input_protocol(case):
    size, parts, kw = PARTS[case]
    return lambda M: M.mixed_layer(size=size, input=parts(M), **kw)


def _with_protocol(case):
    size, parts, kw = PARTS[case]

    def build(M):
        with M.mixed_layer(size=size, **kw) as m:
            for part in parts(M):
                m += part
        return m
    return build


@pytest.mark.parametrize("protocol", ["input", "with"])
@pytest.mark.parametrize("case", sorted(PARTS))
def test_mixed_part_matches_jax(case, protocol):
    build = (_input_protocol if protocol == "input" else _with_protocol)(case)
    got, _ = check_graph(build, _feed(), seed=2)
    assert got.shape[0] == B


# ------------------------------------------------------------- C15

def _tagging_feats(M, size):
    word = M.embedding_layer(M.data_layer("ids", size=V, is_seq=True),
                             size=D)
    pred = M.embedding_layer(M.data_layer("preds", size=V, is_seq=True),
                             size=2)
    return M.mixed_layer(size=size, input=[
        M.context_projection(word, context_len=3, context_start=-1),
        M.identity_projection(pred)])


def test_jax_mixed_width_fails_only_at_apply():
    """ROADMAP C15, on the JAX side: the demo's sum of a 3 D context part
    and a 2-wide identity part builds, then fails at apply."""
    jax_reset_names()
    feats = _tagging_feats(JL, 3 * D + 2)
    topo = JL.Topology(feats)
    params = topo.init(jax.random.PRNGKey(0))
    ids, lengths = _feed()["ids"]
    seq = JaxSeq(jnp.asarray(ids), jnp.asarray(lengths))
    with pytest.raises(TypeError, match="incompatible shapes"):
        topo.apply(params, {"ids": seq, "preds": seq})


@pytest.mark.parametrize("protocol", ["input", "with"])
def test_port_mixed_width_check_raises_at_config_time(protocol):
    L.reset_names()
    if protocol == "input":
        with pytest.raises(ConfigError, match="context projection yields "
                                              "size 15"):
            _tagging_feats(L, 3 * D + 2)
        return
    x = L.data_layer("x", size=D)
    with pytest.raises(ConfigError, match="dotmul projection yields size 5"):
        with L.mixed_layer(size=4) as m:
            m += L.dotmul_projection(x)


@pytest.mark.parametrize("M", [JL, L], ids=["jax", "port"])
def test_mixed_refusals_both_packages_share(M):
    x = M.data_layer("x", size=D)
    with pytest.raises(Exception, match="empty mixed_layer"):
        with M.mixed_layer(size=D):
            pass
    with M.mixed_layer(size=D) as m:
        m += M.identity_projection(x)
    with pytest.raises(Exception, match="already finalized"):
        m += M.identity_projection(x)


# ------------------------------------------------------------- C14

def test_jax_sequence_conv_pool_fails_at_apply():
    """ROADMAP C14, on the JAX side: its mixed layer of hidden_size over
    the window has no weight, and its apply fails."""
    jax_reset_names()
    words = JL.data_layer("ids", size=V, is_seq=True)
    pooled = JL.networks.sequence_conv_pool(
        JL.embedding_layer(words, size=8), context_len=3, hidden_size=16)
    topo = JL.Topology(pooled)
    params = topo.init(jax.random.PRNGKey(0))
    assert params["__mixed_0__"].keys() == {"b"}
    ids, lengths = _feed()["ids"]
    with pytest.raises(ValueError, match="Incompatible shapes for "
                                         "broadcasting"):
        topo.apply(params, {"ids": JaxSeq(jnp.asarray(ids),
                                          jnp.asarray(lengths))})


def _conv_pool_by_hand(M, context_start=None):
    """The reference's sequence_conv_pool, built from the DSL's parts."""
    emb = M.embedding_layer(M.data_layer("ids", size=V, is_seq=True), size=D)
    window = M.mixed_layer(size=3 * D, input=[M.context_projection(
        emb, context_len=3, context_start=context_start)])
    fc = M.fc_layer(window, size=8, act="relu")
    return M.pooling_layer(fc, pooling_type=M.pooling.Max)


@pytest.mark.parametrize("start", [None, 0])
def test_sequence_conv_pool_matches_the_jax_network_by_hand(start):
    def build(M):
        if M is JL:
            return _conv_pool_by_hand(M, start)
        emb = M.embedding_layer(M.data_layer("ids", size=V, is_seq=True),
                                size=D)
        return M.networks.sequence_conv_pool(emb, context_len=3,
                                             hidden_size=8,
                                             context_start=start)
    got, _ = check_graph(build, _feed(), seed=4)
    assert got.shape == (B, 8)
