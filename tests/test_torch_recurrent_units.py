"""The port's ``layers/recurrent_units.py`` and the step composites of
``layers/networks.py`` (``gru_unit``, ``gru_group``, ``lstmemory_unit``,
``lstmemory_group``) against the JAX package's on the CPU, and against
the port's own whole-sequence layers.

- Each of the four ``recurrent_units`` functions and each of the four
  composites, built with both DSLs over ragged sequences (a row of
  length 1), on JAX's perturbed init carried across with equal key sets
  (``tests/test_torch_recurrent_group.check``): every output, the loss
  and every gradient of parameters and float feeds, JAX under
  ``jax.jit``.  The units run inside custom groups with ``para_prefix``
  sharing, a layer input (the prefix-named full-matrix part) and boots.
- The reference's equivalence claims, on the port alone:
  ``lstmemory_group`` / ``gru_group`` and the two ``*_layer_group``s
  compute what ``lstmemory`` / ``grumemory`` compute on the mapped
  weights, values and gradients, forward and reversed; so does
  ``models/text_rnn``'s ``cell="lstm_group"`` / ``"gru_group"`` against
  its twin on ``text_rnn.twin_params``.

Tolerance: float32 in other summation orders, within TOL = 1e-5 of
each leaf's largest entry.
"""

import pytest
import torch

import paddle_tpu_torch.layers as L
from paddle_tpu_torch.data import DataFeeder
from paddle_tpu_torch.layers.graph import value_data
from paddle_tpu_torch.models import text_rnn
from paddle_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_recurrent_group import (
    B, DIN, E, H, _close, check, feeds)

SEQ = {"x": ("seq", DIN)}


def lstm_layer_group(M, reverse=False):
    x = M.data_layer("x", size=DIN, is_seq=True)
    return M.lstm_recurrent_layer_group(name="g", size=H, input=[x],
                                        seq_reversed=reverse)


def gru_layer_group(M, reverse=False):
    x = M.data_layer("x", size=DIN, is_seq=True)
    return M.gated_recurrent_layer_group(name="g", size=H, input=[x],
                                         seq_reversed=reverse)


def lstm_unit(M):
    """Two lstm_recurrent_units in one step, sharing one para_prefix;
    the first over a layer input (the prefix-named full-matrix part)
    and a projection."""
    x = M.data_layer("x", size=DIN, is_seq=True)

    def step(xt):
        a = M.lstm_recurrent_unit(
            name="ua", size=H, para_prefix="shared",
            input=[xt, M.full_matrix_projection(xt)])
        b = M.lstm_recurrent_unit(name="ub", size=H, input=a,
                                  state_act="relu")
        return M.addto_layer([a, b])
    return M.recurrent_group(step, x)


def gru_unit(M):
    """gated_recurrent_unit over a layer input with a prefix and an
    out_memory booted from a layer; a second unit over its output."""
    x = M.data_layer("x", size=DIN, is_seq=True)
    boot = M.fc_layer(M.data_layer("c", size=E), size=H, act="tanh")

    def step(xt):
        mem = M.memory(name="ga", size=H, boot_layer=boot)
        a = M.gated_recurrent_unit(name="ga", size=H, input=xt,
                                   para_prefix="p", out_memory=mem)
        return M.gated_recurrent_unit(name="gb", size=H, input=[a])
    return M.recurrent_group(step, x, reverse=True)


def net_lstm_group(M, boot=False, reverse=False):
    x = M.data_layer("x", size=4 * H, is_seq=True)
    mb = M.fc_layer(M.data_layer("c", size=E), size=H) if boot else None
    return M.networks.lstmemory_group(x, size=H, name="lg", reverse=reverse,
                                      memory_boot=mb)


def net_gru_group(M, naive=False, reverse=False):
    x = M.data_layer("x", size=3 * H, is_seq=True)
    return M.networks.gru_group(x, size=H, name="gg", naive=naive,
                                reverse=reverse)


def net_lstm_unit(M):
    """lstmemory_unit in a custom group: an h boot of width size (widened
    to [h | 0]) and a named, shared recurrent weight."""
    x = M.data_layer("x", size=4 * H, is_seq=True)
    mb = M.fc_layer(M.data_layer("c", size=E), size=H, act="tanh")

    def step(xt):
        return M.networks.lstmemory_unit(xt, size=H, name="lu",
                                         memory_boot=mb,
                                         param_attr={"name": "wr"})
    return M.last_seq(M.recurrent_group(step, x))


def net_gru_unit(M):
    x = M.data_layer("x", size=DIN, is_seq=True)
    mb = M.fc_layer(M.data_layer("c", size=E), size=H, act="tanh")

    def step(xt):
        x3 = M.fc_layer(xt, size=3 * H, act=None, bias_attr=False)
        return M.networks.gru_unit(x3, size=H, name="gu", memory_boot=mb,
                                   naive=True)
    return M.recurrent_group(step, x)


BOOT = {"c": ("dense", E)}
CASES = {
    "lstm_recurrent_layer_group": (lstm_layer_group, SEQ),
    "lstm_recurrent_layer_group_reversed": (
        lambda M: lstm_layer_group(M, True), SEQ),
    "gated_recurrent_layer_group": (gru_layer_group, SEQ),
    "lstm_recurrent_unit": (lstm_unit, SEQ),
    "gated_recurrent_unit": (gru_unit, {**SEQ, **BOOT}),
    "networks_lstmemory_group": (net_lstm_group, {"x": ("seq", 4 * H)}),
    "networks_lstmemory_group_booted_reversed": (
        lambda M: net_lstm_group(M, boot=True, reverse=True),
        {"x": ("seq", 4 * H), **BOOT}),
    "networks_gru_group": (net_gru_group, {"x": ("seq", 3 * H)}),
    "networks_gru_group_naive_reversed": (
        lambda M: net_gru_group(M, naive=True, reverse=True),
        {"x": ("seq", 3 * H)}),
    "networks_lstmemory_unit": (net_lstm_unit, {"x": ("seq", 4 * H),
                                                **BOOT}),
    "networks_gru_unit": (net_gru_unit, {**SEQ, **BOOT}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_and_composites_match_jax(case):
    build, spec = CASES[case]
    check(build, spec)


# ------------------------------------------------ the equivalence claims

def _grad_run(topo, params, feed):
    """(output, {key/name: grad}) of sum(out * cos(0.37 k))."""
    params = {k: {n: t.detach().clone().requires_grad_(True)
                  for n, t in v.items()} for k, v in params.items()}
    out = value_data(topo.apply(params, feed, mode="test"))
    cot = torch.cos(0.37 * torch.arange(out.numel(), dtype=torch.float32))
    (out * cot.reshape(out.shape)).sum().backward()
    return out.detach(), {f"{k}/{n}": t.grad for k, v in params.items()
                          for n, t in v.items()}


def _perturbed(topo, seed):
    gen = torch.Generator().manual_seed(seed)
    params = topo.init(gen, device="cpu")
    return {k: {n: t + 0.1 * torch.randn(t.shape, generator=gen)
                for n, t in v.items()} for k, v in params.items()}


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_networks_groups_equal_the_whole_sequence_layers(kind, reverse):
    """networks.lstmemory_group / gru_group on the weights of their
    lstmemory / grumemory: the recurrent projection and the step bias
    (LSTM), the step layer's three leaves (GRU)."""
    width = 4 * H if kind == "lstm" else 3 * H
    _, feed = feeds({"x": ("seq", width)})
    L.reset_names()
    group = L.Topology(net_lstm_group(L, reverse=reverse) if kind == "lstm"
                       else net_gru_group(L, reverse=reverse))
    L.reset_names()
    x = L.data_layer("x", size=width, is_seq=True)
    whole = L.Topology(L.lstmemory(x, size=H, reverse=reverse)
                       if kind == "lstm" else
                       L.grumemory(x, size=H, reverse=reverse))
    gp = _perturbed(group, 1)
    wkey = whole.order[-1].name
    wp = ({wkey: {"w": gp["lg_unit_input_recurrent"]["w1"],
                  "b": gp["lg_unit_state"]["b"]}} if kind == "lstm"
          else {wkey: gp["gg_out"]})
    got, ggrad = _grad_run(group, gp, feed)
    want, wgrad = _grad_run(whole, wp, feed)
    _close(got.numpy(), want.numpy(), "output")
    names = ({"lg_unit_input_recurrent/w1": f"{wkey}/w",
              "lg_unit_state/b": f"{wkey}/b"} if kind == "lstm" else
             {f"gg_out/{n}": f"{wkey}/{n}" for n in ("w_gate", "w_state",
                                                     "b")})
    for g, w in names.items():
        _close(ggrad[g].numpy(), wgrad[w].numpy(), g)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_layer_groups_equal_a_projection_and_the_whole_sequence_layer(kind):
    """The reference's claim for LstmRecurrentLayerGroup /
    GatedRecurrentLayerGroup (JAX's tests/test_recurrent_units.py)."""
    _, feed = feeds(SEQ, seed=2)
    L.reset_names()
    group = L.Topology(lstm_layer_group(L) if kind == "lstm"
                       else gru_layer_group(L))
    L.reset_names()
    x = L.data_layer("x", size=DIN, is_seq=True)
    k = 4 if kind == "lstm" else 3
    proj = L.mixed_layer(size=k * H, input=[L.full_matrix_projection(x)],
                         name="proj")
    whole = L.Topology(L.lstmemory(proj, size=H) if kind == "lstm"
                       else L.grumemory(proj, size=H))
    gp = _perturbed(group, 3)
    wkey = whole.order[-1].name
    wp = {"proj": {"w0": gp["g_transform_input"]["w0"]},
          wkey: ({"w": gp["g_input_recurrent"]["w1"], "b": gp["g_hc"]["b"]}
                 if kind == "lstm" else dict(gp["g_gate.w"]))}
    got, _ = _grad_run(group, gp, feed)
    want, _ = _grad_run(whole, wp, feed)
    _close(got.numpy(), want.numpy(), "output")


@pytest.mark.parametrize("cell", sorted(text_rnn.TWINS))
def test_text_rnn_group_cells_equal_their_twins(cell):
    """text_rnn at a small size: the group cell's loss and every
    gradient equal its twin's on text_rnn.twin_params."""
    vocab, hidden, batch, seq = 50, 8, B, 6
    data = next(iter(text_rnn.batches(5, 1, batch=batch, seq_len=seq,
                                      vocab=vocab)()))
    data[1] = (data[1][0][:1], data[1][1])          # a row of length 1
    feed = DataFeeder(text_rnn.feeding(vocab), device="cpu")(data)

    def run(c, params):
        topo = L.Topology(text_rnn.build(vocab=vocab, hidden=hidden, cell=c))
        params = {k: {n: t.detach().clone().requires_grad_(True)
                      for n, t in v.items()} for k, v in params.items()}
        loss = torch.mean(value_data(topo.apply(params, feed, mode="test")))
        loss.backward()
        return float(loss.detach()), params

    group_topo = L.Topology(text_rnn.build(vocab=vocab, hidden=hidden,
                                           cell=cell))
    gp = _perturbed(group_topo, 4)
    loss, gparams = run(cell, gp)
    twin_loss, tparams = run(text_rnn.TWINS[cell],
                             text_rnn.twin_params(gp, cell))
    _close(loss, twin_loss, "loss")
    mapped = text_rnn.twin_params(gparams, cell)
    for k in tparams:
        for n in tparams[k]:
            _close(mapped[k][n].grad.numpy(), tparams[k][n].grad.numpy(),
                   f"{k}/{n}")
    with pytest.raises(ValueError, match="has no twin"):
        text_rnn.twin_params(gp, "lstm")
    assert len(tree_leaves(mapped)) == len(tree_leaves(tparams))
