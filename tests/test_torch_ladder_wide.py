"""The legacy ladder's model functions at a wide head: the LM at D 512
over 2 heads (dh 256), 1 layer, on the CPU, against the JAX package's.

``lm_prefill`` (the flash route at dh 256; over an int8 cache
``flash_attention_quant``) and then three Tq=1 steps, ``lm_decode_step_
slots`` on the prefill's slab cache and ``lm_decode_step_paged`` on a
pool holding the same positions through block tables; JAX's Pallas
kernels run in interpret mode where its rules take them
(``forced_prefill_quant_mode("always")``, ``forced_mode("always")``), the
port's wrappers take their plain versions.  On the card the same
calls launch the wide flash instances and the split-KV Tq=1 kernels at
that width (``chip_smoke.py``'s ``ladder_dh256`` phases).

Tolerances: logits 1e-4 absolute and relative (float32 K/V differ by
ulps between the frameworks); over an int8 cache the logits within
``quant/kv.LOGIT_ERR_BUDGET`` (0.06) of JAX's, as
``tests/test_torch_quant.py`` holds them.
"""

import functools
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jax_tf
from paddle_tpu.ops.pallas import decode_attention as jax_dk
from paddle_tpu_torch.models import transformer as torch_tf
from paddle_tpu_torch.ops.kernels import decode_attention as dk
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.quant import kv as kvq

# the ops.pallas package re-exports the flash_attention function under
# the submodule's name
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = 1e-4
VOCAB, D, HEADS, MAX_LEN, BS = 50, 512, 2, 32, 8
PROMPT, STEPS = 12, 3


@functools.lru_cache(maxsize=None)
def _trunk():
    jp = jax_tf.init(jax.random.PRNGKey(3), src_vocab=VOCAB, trg_vocab=1,
                     d_model=D, num_heads=HEADS, dff=64, enc_layers=1,
                     dec_layers=0, max_len=MAX_LEN)
    tp = torch_tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    return jp, tp


def _tables(b):
    """Each row's chain of distinct pool blocks (block 0 left free)."""
    nb_row = MAX_LEN // BS
    ids = np.random.RandomState(5).permutation(np.arange(1, b * nb_row + 1))
    return ids.reshape(b, nb_row).astype(np.int32)


def _to_pool(cache, tables, num_blocks, arr):
    """A prefill's slab cache [B, MAX_LEN, ...] written into a pool
    [num_blocks, BS, ...] along each row's table."""
    pool = []
    for c in cache:
        layer = {}
        for key, x in c.items():
            x = np.asarray(x)
            buf = np.zeros((num_blocks, BS) + x.shape[2:], x.dtype)
            for r in range(x.shape[0]):
                for j, blk in enumerate(tables[r]):
                    buf[blk] = x[r, j * BS:(j + 1) * BS]
            layer[key] = arr(buf)
        pool.append(layer)
    return pool


def _check_logits(got, want, kv_dtype):
    if kv_dtype is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    else:
        err = kvq.logit_err(torch.tensor(np.asarray(want)), got)
        assert (err <= kvq.LOGIT_ERR_BUDGET).all(), float(err.max())


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_prefill_then_tq1_steps_match_jax(layout, kv_dtype):
    jp, tp = _trunk()
    dh = D // HEADS
    assert dh == 256 and dk.covers(HEADS, D, D, BS)
    assert fk.prefill_quant_covers(D, D, HEADS)
    rng = np.random.RandomState(11)
    prompt = rng.randint(1, VOCAB, (2, PROMPT)).astype(np.int32)
    with jax_fa.forced_prefill_quant_mode("always"):
        jh, jc = jax_tf.lm_prefill(jp, jnp.asarray(prompt), MAX_LEN, HEADS,
                                   kv_dtype=kv_dtype)
    th, tc = torch_tf.lm_prefill(tp, prompt, MAX_LEN, HEADS,
                                 kv_dtype=kv_dtype)
    _check_logits(torch_tf._lm_project(tp, th),
                  jax_tf._lm_project(jp, jh), kv_dtype)
    extra_j, extra_t = (), ()
    if layout == "paged":
        tables = _tables(2)
        nb = int(tables.max()) + 1
        jc = _to_pool(jc, tables, nb, jnp.asarray)
        tc = _to_pool(tc, tables, nb, torch.tensor)
        extra_j, extra_t = (jnp.asarray(tables),), (torch.tensor(tables),)
    suffix = "paged" if layout == "paged" else "slots"
    step_j = getattr(jax_tf, f"lm_decode_step_{suffix}")
    step_t = getattr(torch_tf, f"lm_decode_step_{suffix}")
    pos = np.asarray([PROMPT, PROMPT], np.int32)
    toks = prompt[:, -1]
    for _ in range(STEPS):
        with jax_dk.forced_mode("always"):
            jl, jc = step_j(jp, *map(jnp.asarray, (toks, pos)), jc, *extra_j,
                            HEADS)
        tl, tc = step_t(tp, toks, pos, tc, *extra_t, HEADS)
        _check_logits(tl, jl, kv_dtype)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
