"""The bf16 compute policy of the port (``paddle_tpu_torch/core/dtypes``,
``ops/linear.matmul``, ``SGD(compute_dtype=)``) against the JAX
package's (``paddle_tpu/core/dtypes``, ``paddle_tpu/ops/linear``,
``paddle_tpu/trainer``) on the CPU.

Tolerances: under the float32 policy the products are float32 in other
summation orders (1e-5 of the largest entry).  Under the bf16 policy
both packages round the operands to bf16 and accumulate in float32, so
the products agree to float32 summation order (1e-5 of the largest
entry) and equal the port's own float32 product of the rounded operands
bit for bit; a gradient comes back rounded to bf16 by both, so a sum
that lands near a rounding boundary may round one bf16 step apart
(2^-7 relative, plus 1e-5 of the largest entry for sums near zero).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core import dtypes as jax_dtypes
from paddle_tpu.ops import linear as jax_linear
import paddle_tpu_torch.layers as L
from paddle_tpu_torch import optim
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.data import dense_vector, integer_value
from paddle_tpu_torch.ops import linear
from paddle_tpu_torch.trainer import SGD, events
from paddle_tpu_torch.utils.tree import tree_leaves

REL = 1e-5
ULP = 2.0 ** -7       # one bf16 step, relative


@pytest.fixture
def policy():
    """Both packages' policies restored to auto after the test."""
    yield
    dtypes.set_policy()
    jax_dtypes.set_policy()


def test_policy_api_sets_and_restores(policy):
    assert dtypes.compute_dtype() == torch.float32     # auto: float32
    assert dtypes.param_dtype() == torch.float32
    dtypes.set_policy(compute_dtype="bfloat16")
    assert dtypes.compute_dtype() == torch.bfloat16
    x = torch.ones(3, dtype=torch.float32)
    assert dtypes.to_compute(x).dtype == torch.bfloat16
    ids = torch.arange(3)
    assert dtypes.to_compute(ids) is ids                # ints pass through
    dtypes.set_policy("float64", torch.float16)
    assert dtypes.compute_dtype() == torch.float16
    assert dtypes.to_param(x).dtype == torch.float64
    dtypes.set_policy()
    assert dtypes.compute_dtype() == torch.float32
    assert dtypes.param_dtype() == torch.float32


def test_cast_tree_casts_float32_leaves_only():
    """float32 tensors and a SequenceBatch's float32 data cast; ids,
    lengths, masks and other float dtypes pass through; containers keep
    their types."""
    data = torch.randn(2, 3, 4)
    lengths = torch.tensor([3, 1], dtype=torch.int32)
    ids = SequenceBatch(torch.tensor([[1, 2, 3], [4, 0, 0]]), lengths)
    half = torch.randn(2, dtype=torch.float16)
    tree = {"seq": SequenceBatch(data, lengths), "ids": ids,
            "mask": torch.tensor([True, False]), "half": half,
            "list": [torch.randn(2), (torch.randn(1), 3)]}
    out = dtypes.cast_tree(tree, torch.bfloat16)
    assert isinstance(out["seq"], SequenceBatch)
    assert out["seq"].data.dtype == torch.bfloat16
    assert torch.equal(out["seq"].data, data.to(torch.bfloat16))
    assert out["seq"].lengths is lengths
    assert out["ids"].data is ids.data and out["ids"].lengths is lengths
    assert out["mask"] is tree["mask"] and out["half"] is half
    assert isinstance(out["list"], list) and isinstance(out["list"][1],
                                                        tuple)
    assert out["list"][0].dtype == torch.bfloat16
    assert out["list"][1][0].dtype == torch.bfloat16
    assert out["list"][1][1] == 3


def _operands(seed=0, lead=(64,), k=256, n=128):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(lead + (k,)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("lead", [(64,), (2, 32)], ids=["2d", "3d"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_matmul_follows_the_policy_as_jax(policy, cd, lead):
    """f32 operands under each policy: the product in float32, within
    1e-5 of JAX's; under bf16 the operands are rounded (the port's CPU
    route is the float32 product of the rounded operands, bit for bit)
    and the result is NOT the float32 product of the unrounded ones."""
    x, w = _operands(lead=lead)
    dtypes.set_policy(compute_dtype=cd)
    jax_dtypes.set_policy(compute_dtype=cd)
    want = np.asarray(jax_linear.matmul(jnp.asarray(x), jnp.asarray(w)))
    got = linear.matmul(torch.tensor(x), torch.tensor(w))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=REL,
                               atol=REL * np.abs(want).max())
    exact = torch.tensor(x) @ torch.tensor(w)
    if cd == "float32":
        np.testing.assert_array_equal(got.numpy(), exact.numpy())
    else:
        bf = torch.bfloat16
        rounded = (torch.tensor(x).to(bf).float()
                   @ torch.tensor(w).to(bf).float())
        np.testing.assert_array_equal(got.numpy(), rounded.numpy())
        assert np.abs(got.numpy() - exact.numpy()).max() > 1e-3


def test_matmul_gradients_under_bf16_match_jax(policy):
    """d/dx and d/dw of sum(matmul(x, w) * g) on f32 operands under the
    bf16 policy: both packages return float32 gradients holding bf16
    values (the operands' casts round them), within one bf16 step."""
    x, w = _operands(seed=1, lead=(16,), k=128, n=64)
    g = np.random.RandomState(2).standard_normal((16, 64)).astype(
        np.float32)
    dtypes.set_policy(compute_dtype="bfloat16")
    jax_dtypes.set_policy(compute_dtype="bfloat16")
    want = jax.grad(lambda a, b: jnp.sum(jax_linear.matmul(a, b) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    (linear.matmul(tx, tw) * torch.tensor(g)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad), want):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        # bf16 values: rounding to bf16 changes nothing
        assert torch.equal(got, got.to(torch.bfloat16).float())
        np.testing.assert_allclose(got.numpy(), ref, rtol=ULP,
                                   atol=REL * np.abs(ref).max())


def _xor_reader(n=256, batch=32, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 2).astype(np.float32)
    ys = ((xs[:, 0] > 0) ^ (xs[:, 1] > 0)).astype(np.int64)

    def reader():
        for i in range(0, n, batch):
            yield [(xs[j], int(ys[j])) for j in range(i, min(i + batch, n))]
    return reader


def test_bf16_compute_dtype_trains_with_f32_master(policy):
    """The port's twin of tests/test_trainer.py's
    test_bf16_compute_dtype_trains_with_f32_master (without its
    Inferencer part, ROADMAP A9·c): compute_dtype=bf16 converges on XOR,
    the masters and the optimizer slots stay float32, and the forward
    reads bf16 parameters and feed."""
    L.reset_names()
    x = L.data_layer("x", size=2)
    lab = L.data_layer("lab", size=1)
    h = L.fc_layer(x, size=16, act="tanh")
    y = L.fc_layer(h, size=2, act="softmax")
    cost = L.classification_cost(y, lab)
    trainer = SGD(cost=cost, update_equation=optim.Adam(learning_rate=0.05),
                  compute_dtype=torch.bfloat16, device="cpu")
    seen_dtypes = set()
    apply = trainer.topology.apply

    def spy(params, feed, **kw):
        seen_dtypes.update(p.dtype for p in tree_leaves(params))
        seen_dtypes.add(feed["x"].dtype)
        return apply(params, feed, **kw)

    trainer.topology.apply = spy
    feeding = {"x": dense_vector(2), "lab": integer_value(2)}
    seen = []
    trainer.train(_xor_reader(), num_passes=12,
                  event_handler=lambda e: seen.append(e)
                  if isinstance(e, events.EndIteration) else None,
                  feeding=feeding, log_period=0, buffered_batches=0)
    first = np.mean([float(e.cost) for e in seen[:8]])
    last = np.mean([float(e.cost) for e in seen[-8:]])
    assert last < 0.5 * first, (first, last)
    assert seen_dtypes == {torch.bfloat16}
    for leaf in tree_leaves(trainer.parameters):
        assert leaf.dtype == torch.float32, leaf.dtype
    for leaf in tree_leaves(trainer.opt_state["slots"]):
        assert leaf.dtype == torch.float32, leaf.dtype
    # test() casts as the step does and reduces in float32
    assert np.isfinite(trainer.test(_xor_reader(n=64), feeding=feeding))
