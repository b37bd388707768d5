"""Transformer-base (``paddle_tpu/models/transformer.py``): the decoder-only
LM trunk that serves, and the seq2seq MT model with the full-sequence
training entry (``loss``, ``lm_logits``, ``lm_loss``).

Pre-LN blocks over a tied token embedding, learned or rotary positions,
grouped-query attention carried by the weight shapes (``wk``/``wv``
project to ``num_kv_heads * head_dim``).  Parameters are a nested dict of
tensors with the JAX pytree's keys, so carrying JAX weights over is a
mapping (``params_from_numpy``):

    {"src_emb": [V, d], "pos": [max_len, d] (learned only),
     "enc": [{"ln1": {"g", "b"}, "attn": {"wq", "wk", "wv", "wo"},
              "ln2": {"g", "b"}, "ffn": {"w1", "b1", "w2", "b2"}}, ...],
     "ln_f": {"g", "b"}}

and the seq2seq tree (``init``) adds ``"trg_emb": [V_trg, d]``,
``"dec": [{... as "enc", plus "ln_x": {"g", "b"}, "xattn": {"wq", "wk",
"wv", "wo"}}, ...]`` and ``"out": [d, V_trg]``.

Weights are ``[in, out]``.  Where the JAX functions return a new KV cache
(and the engine donated the old one), these write the cache in place and
return the same list.  The KV cache is a slab ``[S, max_len, Dkv]`` per
layer (``init_lm_cache``) or a shared block pool ``[num_blocks,
block_size, Dkv]`` walked through per-row block tables
(``init_lm_cache_paged``), float32 or, with ``kv_dtype="int8"``, int8
codes plus f32 scale sidecars ``{"ks", "vs"}`` per (position, KV head)
(``quant/kv.py``): each position's K/V is quantized on the write and
every read, the step's own write included, sees the quantize ->
dequantize round trip.  Five attention kernels carry this file, one per
step kind — ``decode_attention_slab_chunk`` / ``_paged_chunk`` (the
chunked serving steps), ``decode_attention_slab`` / ``_paged`` (the
Tq=1 steps of the legacy ladder), each handed the int8 cache and its
sidecars as they are, at the head widths ``decode_attention.covers``
admits (elsewhere the step attends through ``_attend``, as JAX's model
does) — and ``flash_attention`` (``flash_attention_quant`` on an int8
cache) in the prefill's batched causal pass; each dispatches on the
device of the tensors it is handed.  Every ``lm_*`` entry point also
takes an int8 weight tree (``quant/weights.quantize_lm``): it
dequantizes at the matmul boundary inside the call, so the float32
weights are a transient of the call, as in the JAX package's step.  The training path
(``encode``/``decode`` with ``full_seq=True``) attends through
``ops/attention.dot_product_attention``'s flash route: the flash forward
and its dK/dV and dQ kernels, through ``FlashAttention``.

Not ported (ROADMAP): MoE blocks, tensor-parallel ``shard_axis``, ``remat``, the sequence-parallel ring (``mesh``,
``zigzag``), packed rows (``segment_ids``/``positions``) and beam-search
generation.
"""

import math

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import embedding as emb_ops
from paddle_tpu_torch.ops import linear, losses
from paddle_tpu_torch.ops.kernels import decode_attention as _decode_kernel
from paddle_tpu_torch.ops.kernels import flash_attention as _flash_kernel
from paddle_tpu_torch.ops.norm import layer_norm
from paddle_tpu_torch.quant import kv as kvq
from paddle_tpu_torch.quant.weights import (dequantize_leaf as _dequant_leaf,
                                            is_quantized_leaf as _w_quantized,
                                            map_leaves as _map_leaves,
                                            maybe_dequant as _maybe_dequant,
                                            weight_shape as _w_shape)
from paddle_tpu_torch.utils.tree import tree_map

_ROADMAP = "not yet ported to paddle_tpu_torch (ROADMAP)"


# ------------------------------------------------------------- params

def _dense(gen, din, dout, scale=None):
    s = scale or (1.0 / math.sqrt(din))
    return s * torch.randn((din, dout), generator=gen, device=gen.device)


def _norm(d, dev):
    return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}


def _kv_width(d_model, num_heads, num_kv_heads):
    if d_model % num_heads:
        raise ValueError(f"num_heads={num_heads} does not divide "
                         f"d_model={d_model}")
    if num_kv_heads is None:
        return d_model
    if num_heads % num_kv_heads:
        raise ValueError(f"num_heads={num_heads} not divisible by "
                         f"num_kv_heads={num_kv_heads}")
    return (d_model // num_heads) * num_kv_heads


def _block(gen, d, dff, d_kv, cross=False):
    """One pre-LN block drawn from ``gen``: self-attention and dense FFN,
    plus ``ln_x``/``xattn`` (cross-attention) for a decoder block."""
    dev = gen.device
    blk = {
        "ln1": _norm(d, dev),
        "attn": {"wq": _dense(gen, d, d), "wk": _dense(gen, d, d_kv),
                 "wv": _dense(gen, d, d_kv), "wo": _dense(gen, d, d)},
        "ln2": _norm(d, dev),
        "ffn": {"w1": _dense(gen, d, dff), "b1": torch.zeros(dff, device=dev),
                "w2": _dense(gen, dff, d), "b2": torch.zeros(d, device=dev)},
    }
    if cross:
        blk["ln_x"] = _norm(d, dev)
        blk["xattn"] = {key: _dense(gen, d, d)
                        for key in ("wq", "wk", "wv", "wo")}
    return blk


def init_lm(generator, vocab, d_model, num_heads, dff, layers, max_len,
            num_kv_heads=None, pos_type="learned", device=None):
    """Random decoder-only trunk drawn from ``generator`` (the port's own
    init — it does not reproduce JAX's random bits).  Normal weights
    scaled 1/sqrt(fan_in), embedding and learned positions at 0.02, layer
    norms at (1, 0), biases 0 — the JAX ``init`` scheme with
    ``dec_layers=0``."""
    dev = _device.resolve(device)
    if pos_type not in ("learned", "rope"):
        raise ValueError(f"pos_type must be 'learned' or 'rope', got "
                         f"{pos_type!r}")
    d_kv = _kv_width(d_model, num_heads, num_kv_heads)
    gen = generator
    params = {"src_emb": _dense(gen, vocab, d_model, scale=0.02)}
    if pos_type == "learned":
        params["pos"] = 0.02 * torch.randn((max_len, d_model), generator=gen,
                                           device=gen.device)
    params["enc"] = [_block(gen, d_model, dff, d_kv) for _ in range(layers)]
    params["ln_f"] = _norm(d_model, gen.device)
    return tree_map(lambda t: t.to(dev), params)


def init(generator, src_vocab=30000, trg_vocab=30000, d_model=512,
         num_heads=8, dff=2048, enc_layers=6, dec_layers=6, max_len=512,
         device=None):
    """Random seq2seq tree drawn from ``generator`` (the port's own init,
    as ``init_lm``): source and target embeddings, learned positions,
    ``enc_layers`` encoder and ``dec_layers`` decoder blocks, the final
    norm and the output projection.  (A JAX tree with GQA encoder blocks
    or rope positions runs too, through ``params_from_numpy``.)"""
    dev = _device.resolve(device)
    _kv_width(d_model, num_heads, None)
    gen = generator
    params = {"src_emb": _dense(gen, src_vocab, d_model, scale=0.02),
              "trg_emb": _dense(gen, trg_vocab, d_model, scale=0.02),
              "pos": 0.02 * torch.randn((max_len, d_model), generator=gen,
                                        device=gen.device)}
    params["enc"] = [_block(gen, d_model, dff, d_model)
                     for _ in range(enc_layers)]
    params["dec"] = [_block(gen, d_model, dff, d_model, cross=True)
                     for _ in range(dec_layers)]
    params["ln_f"] = _norm(d_model, gen.device)
    params["out"] = _dense(gen, d_model, trg_vocab)
    return tree_map(lambda t: t.to(dev), params)


_DEC_KEYS = ("ln1", "attn", "ln_x", "xattn", "ln2", "ffn")


def params_from_numpy(tree, device=None):
    """A JAX param tree as numpy arrays (``jax.tree_util.tree_map(
    np.asarray, params)``) -> the port's dict, same keys and ``[in,
    out]`` layout, float32 on ``device``.  An LM tree (empty ``dec``)
    drops the unused ``trg_emb``/``out`` leaves; a seq2seq tree keeps
    them and its decoder blocks, each of which must carry ``ln_x`` and
    ``xattn``.  A quantized weight (``quant/weights``: ``{"q", "s"}``
    or ``{"__int8__", "__scale__"}``) keeps its keys, its codes as int8
    and its scales as float32 ``[1, dout]``.  ``moe`` blocks raise."""
    dev = _device.resolve(device)
    for i, blk in enumerate(tree["enc"]):
        if "moe" in blk:
            raise NotImplementedError(f"enc[{i}] is a MoE block; MoE is "
                                      f"{_ROADMAP}")
    keep = {"src_emb": tree["src_emb"], "enc": [
        {k: blk[k] for k in ("ln1", "attn", "ln2", "ffn")}
        for blk in tree["enc"]], "ln_f": tree["ln_f"]}
    if "pos" in tree:
        keep["pos"] = tree["pos"]
    if tree.get("dec"):
        for i, blk in enumerate(tree["dec"]):
            missing = [k for k in _DEC_KEYS if k not in blk]
            if missing:
                raise ValueError(f"dec[{i}] is not a seq2seq decoder block: "
                                 f"it lacks {missing}")
        keep["dec"] = [{k: blk[k] for k in _DEC_KEYS} for blk in tree["dec"]]
        keep["trg_emb"] = tree["trg_emb"]
        keep["out"] = tree["out"]
    def leaf(a):
        if not _w_quantized(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)
        out = {}
        for key, val in a.items():
            if key in ("q", "__int8__"):
                out[key] = torch.tensor(np.asarray(val, np.int8), device=dev)
            else:
                out[key] = torch.tensor(np.asarray(val, np.float32).reshape(
                    1, -1), device=dev)
        return out

    return _map_leaves(leaf, keep)


# ------------------------------------------------------------- blocks

def _ln(p, x):
    return layer_norm(x, p["g"], p["b"])


def _ffn(blk, x):
    h = torch.relu(linear.matmul(x, blk["w1"]) + blk["b1"])
    return linear.matmul(h, blk["w2"]) + blk["b2"]


def _block_ffn(blk, h):
    """The block's dense FFN (a MoE block raises)."""
    if "moe" in blk:
        raise NotImplementedError(f"MoE blocks are {_ROADMAP}")
    return _ffn(blk["ffn"], h)


def _weight(leaf):
    """A weight leaf as float32 (an int8 leaf dequantized)."""
    return _dequant_leaf(leaf) if _w_quantized(leaf) else leaf


def _lm_project(params, h):
    """Final LN + tied-embedding projection -> logits [..., V]; takes a
    quantized tree too (the engine's prefill ladder hands it the raw
    engine params)."""
    return linear.matmul(_ln(params["ln_f"], h), _weight(params["src_emb"]).T)


def _lm_embed(params, ids):
    return emb_ops.embedding_lookup(params["src_emb"], ids)


def _attend(q, k, v, num_heads, mask):
    """q [B, Tq, D] against k/v [B, T, Dkv] under mask [B, T] (shared by
    every query lane) or [B, Tq, T] (per lane) -> [B, Tq, D]: the masked
    plain path; grouped KV heads are repeated up to full heads here."""
    b, tq, d = q.shape
    tk, dkv = k.shape[1], k.shape[2]
    dh = d // num_heads
    hkv = dkv // dh
    qh = q.reshape(b, tq, num_heads, dh).transpose(1, 2)
    kh = attn_ops.repeat_kv_heads(k.reshape(b, tk, hkv, dh).transpose(1, 2),
                                  num_heads)
    vh = attn_ops.repeat_kv_heads(v.reshape(b, tk, hkv, dh).transpose(1, 2),
                                  num_heads)
    mh = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
    out = attn_ops.dot_product_attention(qh, kh, vh, mask=mh)
    return out.transpose(1, 2).reshape(b, tq, d)


def _kernel_covers(c, q, num_heads, paged=False):
    """The decode kernels' route rule (``decode_attention.covers``, JAX's
    ``covers``) for this layer's widths and, paged, its block size."""
    return _decode_kernel.covers(num_heads, q.shape[-1], c["k"].shape[-1],
                                 c["k"].shape[1] if paged else None)


def _attend_cache(c, q, qpos, num_heads, tables=None):
    """The reference's path where the decode kernels do not cover the
    widths: lane (r, i) of q [S, K, D] attends row r's cache -- its
    block chain of the pool when ``tables`` are given -- at cols <=
    qpos[r, i] ([S, K]), an int8 cache dequantized."""
    ks, vs = c.get("ks"), c.get("vs")
    if tables is None:
        k, v = _kv_view(c["k"], ks), _kv_view(c["v"], vs)
    else:
        s, idx = tables.shape[0], tables.long()
        k = _kv_view(c["k"][idx], None if ks is None else ks[idx])
        v = _kv_view(c["v"][idx], None if vs is None else vs[idx])
        k, v = k.reshape(s, -1, k.shape[-1]), v.reshape(s, -1, v.shape[-1])
    cols = torch.arange(k.shape[1], device=qpos.device)
    return _attend(q, k, v, num_heads,
                   cols[None, None, :] <= qpos.long()[:, :, None])


def _rope_flat(x_btd, positions, head_dim):
    """Rope on a flat [B, T, H*head_dim] projection (cached K is stored
    rotated)."""
    b, t, d = x_btd.shape
    xh = x_btd.reshape(b, t, d // head_dim, head_dim).transpose(1, 2)
    xh = attn_ops.rope(xh, positions)
    return xh.transpose(1, 2).reshape(b, t, d)


# ------------------------------------------------------------- KV cache

def _kv_writes(c, k_new, v_new):
    """The one quantize-on-write decision every cached-attention variant
    shares: an int8 cache (``"ks" in c``) quantizes the new K/V per
    (position, KV head) and returns the codes plus their scales; a float
    cache passes them through (scales None)."""
    if "ks" in c:
        k_set, sk = kvq.quantize_heads(k_new, c["ks"].shape[-1])
        v_set, sv = kvq.quantize_heads(v_new, c["vs"].shape[-1])
        return k_set, v_set, sk, sv
    return k_new, v_new, None, None


def _kv_view(k, ks):
    """The matching read: an int8 buffer dequantized by its sidecar,
    identity on the float path.  Only the plain paths read it; a kernel
    is handed the codes and scales as they are."""
    return kvq.dequantize_heads(k, ks) if ks is not None else k


def _kv_commit(c, upd, k_set, v_set, sk, sv):
    """Apply the K/V (and sidecar) writes through ``upd(buffer, value)``,
    which writes in place (the JAX callers donate the cache).  Readers
    then take the sidecars as ``c.get("ks")``/``c.get("vs")``, None on
    the float path."""
    upd(c["k"], k_set)
    upd(c["v"], v_set)
    if sk is not None:
        upd(c["ks"], sk)
        upd(c["vs"], sv)


def _kv_layer_buffers(params, lead_shape, kv_dtype, num_heads):
    """One layer list of K/V buffers ``lead_shape + (Dkv,)``; int8 adds
    the f32 scale sidecars ``{"ks", "vs"}`` of ``lead_shape + (Hkv,)``,
    sized from ``num_heads`` (required: a wrong head count would
    quantize at the wrong granularity)."""
    if kv_dtype not in (None,) + kvq.KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} (supported: "
                         f"{kvq.KV_DTYPES})")
    emb = params["src_emb"]
    # a quantized trunk's float cache is float32, on its codes' device
    ref = next(iter(emb.values())) if _w_quantized(emb) else emb
    fdt = torch.float32 if _w_quantized(emb) else emb.dtype
    d = _w_shape(emb)[1]
    int8 = kv_dtype == "int8"
    if int8:
        if num_heads is None:
            raise ValueError(
                "kv_dtype='int8' needs the trunk's num_heads: the "
                "per-(position, head) scale sidecar is sized Hkv = "
                "Dkv / (d_model / num_heads)")
        if d % num_heads:
            raise ValueError(f"num_heads={num_heads} does not divide "
                             f"d_model={d}")
    layers = []
    for blk in params["enc"]:
        dkv = _w_shape(blk["attn"]["wk"])[1]
        dkv_v = _w_shape(blk["attn"]["wv"])[1]
        dt = torch.int8 if int8 else fdt
        c = {"k": torch.zeros(lead_shape + (dkv,), dtype=dt,
                              device=ref.device),
             "v": torch.zeros(lead_shape + (dkv_v,), dtype=dt,
                              device=ref.device)}
        if int8:
            dh = d // num_heads
            if dkv % dh or dkv_v % dh:
                raise ValueError(
                    f"head_dim {dh} (d_model {d} / num_heads {num_heads}) "
                    f"does not divide Dkv {dkv}/{dkv_v}")
            c["ks"] = torch.zeros(lead_shape + (dkv // dh,),
                                  dtype=torch.float32, device=ref.device)
            c["vs"] = torch.zeros(lead_shape + (dkv_v // dh,),
                                  dtype=torch.float32, device=ref.device)
        layers.append(c)
    return layers


def init_lm_cache(params, batch, max_len, kv_dtype=None, num_heads=None):
    """Per-layer K/V buffers ``{"k", "v"}`` of [batch, max_len, Dkv] on
    the params' device (Dkv from each block's ``wk``/``wv``, so a GQA
    trunk gets the smaller cache).  A learned positional table caps
    ``max_len``.  ``kv_dtype="int8"`` (with the trunk's ``num_heads``):
    int8 buffers plus f32 sidecars ``{"ks", "vs"}`` of [batch, max_len,
    Hkv]."""
    if "pos" in params and max_len > _w_shape(params["pos"])[0]:
        raise ValueError(
            f"lm decode max_len {max_len} exceeds the positional table "
            f"({_w_shape(params['pos'])[0]}); re-init with a larger max_len "
            "or use pos_type='rope'")
    return _kv_layer_buffers(params, (batch, max_len), kv_dtype, num_heads)


def init_lm_cache_paged(params, num_blocks, block_size, max_len=None,
                        kv_dtype=None, num_heads=None):
    """Per-layer K/V block pools ``{"k", "v"}`` of ``[num_blocks,
    block_size, Dkv]`` — the paged twin of ``init_lm_cache``.  Block 0 is
    the scratch block free rows read and write; the allocator
    (``serving/kv_pool.BlockPool``) hands out ids ``1..num_blocks-1``.
    ``max_len``: the logical per-row span, capped by a learned positional
    table exactly like ``init_lm_cache``.  ``kv_dtype="int8"``: int8
    pools plus f32 sidecar pools ``[num_blocks, block_size, Hkv]``."""
    if num_blocks < 2 or block_size < 1:
        raise ValueError(
            f"paged cache needs num_blocks >= 2 (one is the reserved "
            f"scratch block) and block_size >= 1; got {num_blocks}, "
            f"{block_size}")
    if max_len is not None and "pos" in params \
            and max_len > _w_shape(params["pos"])[0]:
        raise ValueError(
            f"lm decode max_len {max_len} exceeds the positional table "
            f"({_w_shape(params['pos'])[0]}); re-init with a larger max_len "
            "or use pos_type='rope'")
    return _kv_layer_buffers(params, (num_blocks, block_size), kv_dtype,
                             num_heads)


def _check_pos_type(params, pos_type):
    if (pos_type == "learned") != ("pos" in params):
        raise ValueError(
            f"pos_type={pos_type!r} but params were initialized "
            f"{'with' if 'pos' in params else 'without'} a learned "
            "positional table — pass the SAME pos_type used at init")


def _ids(x, dev):
    """Token ids / positions as an int32 tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)


# ------------------------------------------------------------- prefill

def lm_prefill(params, prompt, max_len, num_heads=8, moe_top_k=2,
               pos_type="learned", kv_dtype=None):
    """Batched causal pass over the whole prompt [B, Tp]: returns
    (hidden states [B, Tp, D], cache) with every position's K/V written
    into fresh [B, max_len, Dkv] buffers.  The attention is
    ``dot_product_attention``'s flash route, causal, over GQA heads
    repeated to full width first: the ``flash_attention`` kernel, or the
    dense path at a head dim above 128 that is not 256, 384 or 512 (JAX
    takes it there too, except at a multiple of 128 above 512, where its
    kernel computes the same function).  ``kv_dtype="int8"`` quantizes
    each position's K/V on the way into the cache and attends the
    just-quantized codes through ``flash_attention_quant`` (GQA in the
    kernel) where ``prefill_quant_covers`` admits the widths, else their
    dequantized values on the float32 route: the quantize -> dequantize
    round trip that sequential int8 steps attend, so the cache equals
    theirs."""
    del moe_top_k     # MoE blocks raise in _block_ffn
    params = _maybe_dequant(params)
    _check_pos_type(params, pos_type)
    dev = params["src_emb"].device
    prompt = _ids(prompt, dev)
    b, tp = prompt.shape
    cache = init_lm_cache(params, b, max_len, kv_dtype=kv_dtype,
                          num_heads=num_heads)
    x = _lm_embed(params, prompt)
    x = x * math.sqrt(x.shape[-1])
    if pos_type == "learned":
        x = x + params["pos"][:tp][None]
    arange = torch.arange(tp, device=dev)
    for blk, c in zip(params["enc"], cache):
        h = _ln(blk["ln1"], x)
        k = linear.matmul(h, blk["attn"]["wk"])
        v = linear.matmul(h, blk["attn"]["wv"])
        q = linear.matmul(h, blk["attn"]["wq"])
        d = q.shape[-1]
        dh = d // num_heads
        if pos_type == "rope":
            k = _rope_flat(k, arange, dh)
            q = _rope_flat(q, arange, dh)
        hkv = k.shape[-1] // dh
        k_set, v_set, sk, sv = _kv_writes(c, k, v)

        def split(a, hh):
            return a.reshape(b, tp, hh, dh).transpose(1, 2)

        if sk is not None and _flash_kernel.prefill_quant_covers(
                d, k.shape[-1], num_heads):
            att = _flash_kernel.flash_attention_quant(
                q.contiguous(), k_set, v_set, sk, sv, num_heads, causal=True)
        else:
            if sk is not None:      # the quantize -> dequantize round trip
                k, v = _kv_view(k_set, sk), _kv_view(v_set, sv)
            # the flash route (a head dim its kernels do not take goes
            # to the dense path there)
            att = attn_ops.dot_product_attention(
                split(q, num_heads),
                attn_ops.repeat_kv_heads(split(k, hkv), num_heads),
                attn_ops.repeat_kv_heads(split(v, hkv), num_heads),
                causal=True, use_flash=True)
        att = att.transpose(1, 2).reshape(b, tp, d)
        x = x + linear.matmul(att, blk["attn"]["wo"])
        x = x + _block_ffn(blk, _ln(blk["ln2"], x))
        _kv_commit(c, lambda buf, val: buf[:, :tp].copy_(val),
                   k_set, v_set, sk, sv)
    return x, cache


# ------------------------------------------------------------- decode

def _cached_self_attn(blk, x, c, t, pos_mask, num_heads, rope_pos=None):
    """One position's self-attention over the cache: write this
    position's K/V at ``t`` (in place), attend cols <= t, residual-add."""
    h = _ln(blk["ln1"], x)
    k_new = linear.matmul(h, blk["attn"]["wk"])
    q = linear.matmul(h, blk["attn"]["wq"])
    if rope_pos is not None:
        dh = q.shape[-1] // num_heads
        k_new = _rope_flat(k_new, rope_pos, dh)
        q = _rope_flat(q, rope_pos, dh)
    v_new = linear.matmul(h, blk["attn"]["wv"])
    k_set, v_set, sk, sv = _kv_writes(c, k_new, v_new)
    _kv_commit(c, lambda buf, val: buf[:, t:t + 1].copy_(val),
               k_set, v_set, sk, sv)
    att = _attend(q, _kv_view(c["k"], c.get("ks")),
                  _kv_view(c["v"], c.get("vs")),
                  num_heads, pos_mask)
    return x + linear.matmul(att, blk["attn"]["wo"])


def lm_decode_step(params, prev_ids, t, cache, num_heads=8, moe_top_k=2,
                   pos_type="learned"):
    """One incremental position for the whole batch at shared position
    ``t`` (a Python int): prev_ids [B] -> (logits [B, V], cache), the
    cache (float32 or int8, ``init_lm_cache``) written in place.  The
    attention is the masked plain path over ``_kv_view``, as in the JAX
    package (no kernel)."""
    del moe_top_k
    params = _maybe_dequant(params)
    dev = params["src_emb"].device
    prev_ids = _ids(prev_ids, dev)
    b = prev_ids.shape[0]
    max_len = cache[0]["k"].shape[1]
    x = _lm_embed(params, prev_ids)[:, None]
    x = x * math.sqrt(x.shape[-1])
    if pos_type == "learned":
        x = x + params["pos"][t][None, None]
    rope_pos = (torch.tensor([t], device=dev) if pos_type == "rope"
                else None)
    pos_mask = (torch.arange(max_len, device=dev) <= t)[None].expand(
        b, max_len)
    for blk, c in zip(params["enc"], cache):
        x = _cached_self_attn(blk, x, c, t, pos_mask, num_heads, rope_pos)
        x = x + _block_ffn(blk, _ln(blk["ln2"], x))
    return _lm_project(params, x)[:, 0], cache


def _qkv(blk, x, num_heads, rope_pos):
    """(q, k_new, v_new) projections of ``x`` [S, Tq, D], rope applied
    to q and k at ``rope_pos`` (None: learned positions)."""
    h = _ln(blk["ln1"], x)
    k_new = linear.matmul(h, blk["attn"]["wk"])
    q = linear.matmul(h, blk["attn"]["wq"])
    if rope_pos is not None:
        dh = q.shape[-1] // num_heads
        k_new = _rope_flat(k_new, rope_pos, dh)
        q = _rope_flat(q, rope_pos, dh)
    return q, k_new, linear.matmul(h, blk["attn"]["wv"])


def _step_embed(params, ids, positions, pos_type):
    """Embedded ``ids`` [S] or [S, K] at ``positions`` of the same shape
    -> [S, 1, D] or [S, K, D], scaled by sqrt(D), learned positions
    added."""
    x = _lm_embed(params, ids)
    x = x * math.sqrt(x.shape[-1])
    if pos_type == "learned":
        x = x + params["pos"][positions.long()]
    return x if ids.dim() == 2 else x[:, None]


def _cached_self_attn_slots(blk, x, c, positions, num_heads, rope_pos=None):
    """One position per slot row, each at its own ``positions[r]``: row r
    writes its K/V at (r, positions[r]) in place and its query attends
    cols <= positions[r] through the ``decode_attention_slab`` kernel.
    Row r computes exactly ``_cached_self_attn`` at t = positions[r]."""
    q, k_new, v_new = _qkv(blk, x, num_heads, rope_pos)
    rows = torch.arange(x.shape[0], device=x.device)
    k_set, v_set, sk, sv = _kv_writes(c, k_new[:, 0], v_new[:, 0])
    index = (rows, positions.long())
    _kv_commit(c, lambda buf, val: buf.index_put_(index, val),
               k_set, v_set, sk, sv)
    if _kernel_covers(c, q, num_heads):
        att = _decode_kernel.decode_attention_slab(
            q[:, 0].contiguous(), c["k"], c["v"], positions, num_heads,
            kscale=c.get("ks"), vscale=c.get("vs"))[:, None]
    else:
        att = _attend_cache(c, q, positions[:, None], num_heads)
    return x + linear.matmul(att, blk["attn"]["wo"])


def lm_decode_step_slots(params, prev_ids, positions, cache, num_heads=8,
                         moe_top_k=2, pos_type="learned"):
    """One decode position for EVERY row of a slot slab, each row at its
    OWN position — the continuous-batching twin of ``lm_decode_step``
    (the legacy ladder engine's step).  prev_ids [S], positions [S];
    cache as ``init_lm_cache``, written in place -> (logits [S, V],
    cache)."""
    del moe_top_k
    params = _maybe_dequant(params)
    dev = params["src_emb"].device
    prev_ids = _ids(prev_ids, dev)
    positions = _ids(positions, dev)
    x = _step_embed(params, prev_ids, positions, pos_type)
    rope_pos = positions[:, None] if pos_type == "rope" else None
    for blk, c in zip(params["enc"], cache):
        x = _cached_self_attn_slots(blk, x, c, positions, num_heads,
                                    rope_pos)
        x = x + _block_ffn(blk, _ln(blk["ln2"], x))
    return _lm_project(params, x)[:, 0], cache


def _paged_targets(tables, qpos, block_size):
    """(block ids, offsets) where positions ``qpos`` ([S] or [S, K]) of
    each row live in the pool: ``tables[r, p // bs]``, ``p % bs``."""
    rows = torch.arange(tables.shape[0], device=tables.device)
    if qpos.dim() == 2:
        rows = rows[:, None]
    qpos = qpos.long()
    return tables.long()[rows, qpos // block_size], qpos % block_size


def _cached_self_attn_paged(blk, x, c, positions, tables, num_heads,
                            rope_pos=None):
    """``_cached_self_attn_slots`` over the block pool: row r writes its
    K/V at ``pool[tables[r, p // bs], p % bs]`` (p = positions[r]) in
    place and attends its own chain through the
    ``decode_attention_paged`` kernel.  The host makes every block an
    active row writes exclusive first (``kv_pool.write_plan``).  Free
    rows' tables are all scratch block 0 at position 0, so they write
    (block 0, offset 0) — several free rows write one target with
    different values, harmlessly: no active row ever reads block 0."""
    q, k_new, v_new = _qkv(blk, x, num_heads, rope_pos)
    index = _paged_targets(tables, positions, c["k"].shape[1])
    k_set, v_set, sk, sv = _kv_writes(c, k_new[:, 0], v_new[:, 0])
    _kv_commit(c, lambda buf, val: buf.index_put_(index, val),
               k_set, v_set, sk, sv)
    if _kernel_covers(c, q, num_heads, paged=True):
        att = _decode_kernel.decode_attention_paged(
            q[:, 0].contiguous(), c["k"], c["v"], positions, tables,
            num_heads, kscale=c.get("ks"), vscale=c.get("vs"))[:, None]
    else:
        att = _attend_cache(c, q, positions[:, None], num_heads, tables)
    return x + linear.matmul(att, blk["attn"]["wo"])


def lm_decode_step_paged(params, prev_ids, positions, cache, tables,
                         num_heads=8, moe_top_k=2, pos_type="learned"):
    """The block-pool twin of ``lm_decode_step_slots``: cache as
    ``init_lm_cache_paged`` (written in place), tables [S,
    blocks_per_row] int32 physical block ids -> (logits [S, V], cache).
    Row r computes exactly ``lm_decode_step_slots``'s result at
    t = positions[r]; the table is data, so admission, eviction and
    copy-on-write churn between steps change no shape."""
    del moe_top_k
    params = _maybe_dequant(params)
    dev = params["src_emb"].device
    prev_ids = _ids(prev_ids, dev)
    positions = _ids(positions, dev)
    tables = _ids(tables, dev)
    x = _step_embed(params, prev_ids, positions, pos_type)
    rope_pos = positions[:, None] if pos_type == "rope" else None
    for blk, c in zip(params["enc"], cache):
        x = _cached_self_attn_paged(blk, x, c, positions, tables, num_heads,
                                    rope_pos)
        x = x + _block_ffn(blk, _ln(blk["ln2"], x))
    return _lm_project(params, x)[:, 0], cache


def _chunk_lanes(positions, lengths, kk):
    """(clamped lane indices [S, K], per-lane query positions [S, K]),
    both int32.  Lanes past a row's ``lengths`` clamp to its LAST active
    lane: they re-compute (and re-write) the last real token's K/V —
    identical values at an identical target."""
    lane = torch.arange(kk, device=positions.device,
                        dtype=torch.int32)[None, :]
    li = torch.minimum(lane, lengths[:, None] - 1)
    return li, (positions[:, None] + li).contiguous()


def _cached_self_attn_chunk(blk, x, c, li, qpos, num_heads, rope_pos=None):
    """Self-attention for K lanes per row: lane i of row r writes its K/V
    at ``qpos[r, i]`` (in place) and attends cols <= qpos[r, i] through
    the ``decode_attention_slab_chunk`` kernel.  Writes happen before the
    attention, so causality within the chunk falls out of the masked
    cache read."""
    s = x.shape[0]
    q, k_sel, v_sel = _chunk_qkv(blk, x, li, num_heads, rope_pos)
    k_set, v_set, sk, sv = _kv_writes(c, k_sel, v_sel)
    index = (torch.arange(s, device=x.device)[:, None], qpos.long())
    _kv_commit(c, lambda buf, val: buf.index_put_(index, val),
               k_set, v_set, sk, sv)
    if _kernel_covers(c, q, num_heads):
        att = _decode_kernel.decode_attention_slab_chunk(
            q, c["k"], c["v"], qpos, num_heads, kscale=c.get("ks"),
            vscale=c.get("vs"))
    else:
        att = _attend_cache(c, q, qpos, num_heads)
    return x + linear.matmul(att, blk["attn"]["wo"])


def _chunk_qkv(blk, x, li, num_heads, rope_pos):
    """(q, k_sel, v_sel) for K lanes per row: the K/V each lane writes,
    with inactive lanes (li clamped) taking the last active lane's
    values, so their duplicate-target writes are identical — the one
    reason the unordered duplicate scatter after it is deterministic (on
    an int8 cache identical values quantize to identical codes and
    scales, so that holds there too)."""
    q, k_new, v_new = _qkv(blk, x, num_heads, rope_pos)
    sel = li.long()[:, :, None]
    k_sel = torch.gather(k_new, 1, sel.expand(-1, -1, k_new.shape[-1]))
    v_sel = torch.gather(v_new, 1, sel.expand(-1, -1, v_new.shape[-1]))
    return q, k_sel, v_sel


def _cached_self_attn_chunk_paged(blk, x, c, li, qpos, tables, num_heads,
                                  rope_pos=None):
    """``_cached_self_attn_chunk`` over the block pool: lane i of row r
    writes into ``pool[tables[r, qpos // bs], qpos % bs]`` in place (the
    host provisions exclusive blocks for the whole span before the step)
    and attends its own chain through the ``decode_attention_paged_chunk``
    kernel.  Clamped lanes re-write identical values to identical
    targets; free rows all target scratch block 0, which no active row
    reads."""
    q, k_sel, v_sel = _chunk_qkv(blk, x, li, num_heads, rope_pos)
    index = _paged_targets(tables, qpos, c["k"].shape[1])
    k_set, v_set, sk, sv = _kv_writes(c, k_sel, v_sel)
    _kv_commit(c, lambda buf, val: buf.index_put_(index, val),
               k_set, v_set, sk, sv)
    if _kernel_covers(c, q, num_heads, paged=True):
        att = _decode_kernel.decode_attention_paged_chunk(
            q, c["k"], c["v"], qpos, tables, num_heads, kscale=c.get("ks"),
            vscale=c.get("vs"))
    else:
        att = _attend_cache(c, q, qpos, num_heads, tables)
    return x + linear.matmul(att, blk["attn"]["wo"])


def _chunk_step(params, tokens, positions, lengths, cache, pos_type,
                all_lanes, attn):
    """The chunked step around ``attn(blk, x, c, li, qpos, rope_pos)``,
    one layer's cached self-attention (slab or paged)."""
    params = _maybe_dequant(params)
    dev = params["src_emb"].device
    tokens = _ids(tokens, dev)
    positions = _ids(positions, dev)
    lengths = _ids(lengths, dev)
    s, kk = tokens.shape
    li, qpos = _chunk_lanes(positions, lengths, kk)
    x = _step_embed(params, tokens, qpos, pos_type)
    rope_pos = qpos if pos_type == "rope" else None
    for blk, c in zip(params["enc"], cache):
        x = attn(blk, x, c, li, qpos, rope_pos)
        x = x + _block_ffn(blk, _ln(blk["ln2"], x))
    if all_lanes:
        return _lm_project(params, x), cache
    h_last = x[torch.arange(s, device=dev), (lengths - 1).long()]
    return _lm_project(params, h_last), cache


def lm_decode_chunk_slots(params, tokens, positions, lengths, cache,
                          num_heads=8, moe_top_k=2, pos_type="learned",
                          all_lanes=False):
    """Every slot row advances ``lengths[r]`` (1..K) positions in one
    step: tokens [S, K] (lanes >= lengths[r] ignored), positions [S]
    (lane 0's position), lengths [S]; cache as ``init_lm_cache``, written
    in place -> (logits [S, V] at each row's last fed lane, cache).
    ``all_lanes=True`` projects every lane -> logits [S, K, V]; lanes
    past a row's ``lengths`` are not meaningful there (a decode row's
    dead lanes attend to the kernel's zeros)."""
    del moe_top_k
    return _chunk_step(
        params, tokens, positions, lengths, cache, pos_type, all_lanes,
        lambda blk, x, c, li, qpos, rope: _cached_self_attn_chunk(
            blk, x, c, li, qpos, num_heads, rope))


def lm_decode_chunk_paged(params, tokens, positions, lengths, cache, tables,
                          num_heads=8, moe_top_k=2, pos_type="learned",
                          all_lanes=False):
    """The block-pool twin of ``lm_decode_chunk_slots`` (same lane
    semantics): cache as ``init_lm_cache_paged``, written in place;
    tables [S, blocks_per_row] int32 -> (logits [S, V] at each row's last
    fed lane, cache).  ``all_lanes=True`` (the speculative verify
    surface) projects every lane -> logits [S, K, V], as the slab
    twin."""
    del moe_top_k
    tables = _ids(tables, cache[0]["k"].device)
    return _chunk_step(
        params, tokens, positions, lengths, cache, pos_type, all_lanes,
        lambda blk, x, c, li, qpos, rope: _cached_self_attn_chunk_paged(
            blk, x, c, li, qpos, tables, num_heads, rope))


# ------------------------------------------------------------- generate

def lm_generate(params, prompt, max_len, num_heads=8, temperature=0.0,
                top_k=0, generator=None, eos_id=None, prompt_lengths=None,
                moe_top_k=2, pos_type="learned", kv_dtype=None):
    """Autoregressive generation: prompt [B, Tp] ids -> ids [B, max_len]
    (int32, on the params' device) beginning with each row's prompt.

    ``prompt_lengths`` [B] makes the prompts ragged (rows padded to Tp;
    the pad value never matters).  One ``lm_prefill`` consumes the
    prompt; the per-token loop starts at the SHORTEST row's length and
    re-feeds longer rows' remaining prompt tokens (their K/V rewrites
    are identical).  ``temperature=0`` is greedy argmax; otherwise
    categorical sampling over logits / temperature from ``generator``
    (a ``torch.Generator`` on the params' device), optionally cut to
    the ``top_k`` largest logits.  ``eos_id``: a row that GENERATES it
    keeps emitting it."""
    params = _maybe_dequant(params)
    dev = params["src_emb"].device
    prompt = _ids(prompt, dev)
    b, tp = prompt.shape
    if not 0 < tp <= max_len:
        raise ValueError(f"prompt length {tp} must be in [1, {max_len}]")
    if temperature and generator is None:
        raise ValueError("temperature > 0 sampling needs generator="
                         "torch.Generator(...)")
    vocab = _w_shape(params["src_emb"])[0]
    if top_k and not 0 < top_k <= vocab:
        raise ValueError(f"top_k={top_k} must be in [1, vocab={vocab}]")
    if prompt_lengths is None:
        lengths_np = np.full((b,), tp, np.int32)
    else:
        lengths_np = np.asarray(prompt_lengths, np.int32).reshape(b)
        if lengths_np.min() < 1 or lengths_np.max() > tp:
            raise ValueError(
                f"prompt_lengths must be in [1, {tp}] (got "
                f"[{int(lengths_np.min())}, {int(lengths_np.max())}])")
    t_start = int(lengths_np.min())
    lengths = torch.as_tensor(lengths_np, device=dev)
    rows = torch.arange(b, device=dev)

    def sample(logits):
        if not temperature:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        logits = logits / temperature
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth,
                                 logits.new_tensor(float("-inf")), logits)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=generator)[:, 0].to(torch.int32)

    hidden, cache = lm_prefill(params, prompt, max_len, num_heads,
                               moe_top_k, pos_type, kv_dtype=kv_dtype)
    # each row's first generated token comes from ITS last real position
    # — gather before the d_model x vocab projection
    first = sample(_lm_project(params, hidden[rows, (lengths - 1).long()]))
    ids = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    ids[:, :tp] = prompt
    # a row whose prompt already fills max_len keeps its prompt value
    seed_pos = torch.clamp(lengths, max=max_len - 1).long()
    ids[rows, seed_pos] = torch.where(lengths < max_len, first,
                                      ids[rows, seed_pos])
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(t_start, max_len - 1):
        # the token at t is generated for rows with lengths <= t, still
        # prompt for longer rows (re-fed; identical K/V rewrite)
        tok = ids[:, t]
        logits, cache = lm_decode_step(params, tok, t, cache, num_heads,
                                       moe_top_k, pos_type)
        nxt = sample(logits)
        if eos_id is not None:
            # only a GENERATED eos pins a row
            done = done | ((tok == eos_id) & (t >= lengths))
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        # rows whose prompt extends past t keep their given token; the
        # slot at a row's own length was seeded from the prefill logits
        ids[:, t + 1] = torch.where(t + 1 <= lengths, ids[:, t + 1], nxt)
    return ids


# ------------------------------------------------- full-sequence training

def _not_ported(**options):
    for name, value in options.items():
        if value is not None and value is not False:
            raise NotImplementedError(f"{name}= is {_ROADMAP}")


def _check_full(seq):
    """full_seq=True promises no padding; a batch that breaks it raises
    instead of silently attending padded keys."""
    t = seq.data.shape[1]
    if bool((seq.lengths != t).any()):
        raise ValueError(
            f"full_seq=True but batch has lengths "
            f"{(int(seq.lengths.min()), int(seq.lengths.max()))} < T={t}; "
            "drop full_seq or pack the batch")


def _mha(blk, xq, xkv, num_heads, key_mask=None, causal=False,
         rope_positions=None):
    return attn_ops.multi_head_attention(
        xq, xkv, blk["wq"], blk["wk"], blk["wv"], blk["wo"], num_heads,
        key_mask=key_mask, causal=causal, rope_positions=rope_positions)


def _enc_block(blk, x, key_mask, num_heads, causal=False, rope_pos=None):
    h = _ln(blk["ln1"], x)
    x = x + _mha(blk["attn"], h, h, num_heads, key_mask=key_mask,
                 causal=causal, rope_positions=rope_pos)
    return x + _block_ffn(blk, _ln(blk["ln2"], x))


def _dec_block(blk, x, enc_out, self_km, cross_km, num_heads):
    h = _ln(blk["ln1"], x)
    x = x + _mha(blk["attn"], h, h, num_heads, key_mask=self_km,
                 causal=True)
    x = x + _mha(blk["xattn"], _ln(blk["ln_x"], x), enc_out, num_heads,
                 key_mask=cross_km)
    return x + _ffn(blk["ffn"], _ln(blk["ln2"], x))


def encode(params, src, num_heads=8, remat=False, full_seq=False, mesh=None,
           segment_ids=None, positions=None, causal=False, zigzag=False,
           pos_type="learned"):
    """Encoder stack over ``src`` (a ``SequenceBatch`` of ids [B, T]) ->
    hidden states [B, T, d].  ``causal=True`` is the decoder-only trunk
    (``lm_logits``).  ``full_seq=True`` promises every row is T long
    (checked) and drops the key mask, so the attention takes the flash
    route where T allows it; otherwise keys are masked by ``src``'s
    lengths.  ``remat``, ``mesh``, ``zigzag`` and packed rows
    (``segment_ids``/``positions``) raise."""
    params = _maybe_dequant(params)
    _check_pos_type(params, pos_type)
    _not_ported(remat=remat, mesh=mesh, zigzag=zigzag,
                segment_ids=segment_ids, positions=positions)
    t = src.data.shape[1]
    x = emb_ops.embedding_lookup(params["src_emb"], src.data)
    x = x * math.sqrt(x.shape[-1])
    rope_pos = None
    if pos_type == "rope":
        rope_pos = torch.arange(t, device=x.device)
    else:
        x = x + params["pos"][:t][None]
    key_mask = None if full_seq else src.mask()
    if full_seq:
        _check_full(src)
    for blk in params["enc"]:
        x = _enc_block(blk, x, key_mask, num_heads, causal, rope_pos)
    return x


def decode(params, enc_out, src_mask, trg_in, num_heads=8, remat=False,
           full_seq=False, mesh=None, zigzag=False):
    """Decoder stack: target ids ``trg_in`` (teacher forcing) against
    ``enc_out`` under the source key mask ``src_mask`` [B, Ts] -> logits
    [B, T, V_trg].  Causal self-attention, cross-attention, final norm
    and output projection; ``full_seq`` as in ``encode``."""
    _not_ported(remat=remat, mesh=mesh, zigzag=zigzag)
    t = trg_in.data.shape[1]
    x = emb_ops.embedding_lookup(params["trg_emb"], trg_in.data)
    x = x * math.sqrt(x.shape[-1]) + params["pos"][:t][None]
    self_km = None if full_seq else trg_in.mask()
    cross_km = None if full_seq else src_mask
    if full_seq:
        _check_full(trg_in)
    for blk in params["dec"]:
        x = _dec_block(blk, x, enc_out, self_km, cross_km, num_heads)
    return linear.matmul(_ln(params["ln_f"], x), params["out"])


def forward(params, src, trg_in, num_heads=8, remat=False, full_seq=False,
            mesh=None, zigzag=False):
    enc_out = encode(params, src, num_heads, remat=remat, full_seq=full_seq,
                     mesh=mesh)
    return decode(params, enc_out, src.mask(), trg_in, num_heads,
                  remat=remat, full_seq=full_seq, mesh=mesh, zigzag=zigzag)


def _token_ce(logits, labels, label_smoothing):
    """Per-token (optionally label-smoothed) cross-entropy: JAX's one-hot
    form (a label outside [0, V) gets an all-zero one-hot row)."""
    logp = torch.log_softmax(logits, dim=-1)
    if label_smoothing:
        v = logits.shape[-1]
        onehot = (labels[..., None] == torch.arange(
            v, device=labels.device)).to(logp.dtype)
        smoothed = onehot * (1 - label_smoothing) + label_smoothing / v
        return -(smoothed * logp).sum(-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def loss(params, src, trg_in, trg_next, num_heads=8, label_smoothing=0.1,
         remat=False, full_seq=False, mesh=None, zigzag=False):
    """Label-smoothed cross-entropy of ``forward``'s logits against
    ``trg_next``, averaged over each row's valid target tokens, then over
    the batch (a scalar)."""
    logits = forward(params, src, trg_in, num_heads, remat=remat,
                     full_seq=full_seq, mesh=mesh, zigzag=zigzag)
    labels = trg_next.data
    if labels.dim() == 3:
        labels = labels[..., 0]
    per_tok = _token_ce(logits, labels, label_smoothing)
    per_seq = losses.masked_seq_mean(per_tok,
                                     trg_in.mask(per_tok.dtype))
    return per_seq.mean()


def lm_logits(params, tokens, num_heads=8, **encode_kw):
    """Full-sequence LM logits [B, T, V]: ``encode(causal=True)`` and the
    tied-embedding projection.  ``full_seq=True`` takes the flash route
    where T allows it."""
    params = _maybe_dequant(params)
    return _lm_project(params, encode(params, tokens, num_heads,
                                      causal=True, **encode_kw))


def lm_loss(params, tokens, num_heads=8, segment_ids=None, positions=None,
            mesh=None, zigzag=False, remat=False, label_smoothing=0.0,
            pos_type="learned"):
    """Next-token cross-entropy of the decoder-only trunk, a token mean:
    label t is token t + 1, which must be a real token."""
    ids = tokens.data
    b = ids.shape[0]
    m = tokens.bool_mask()
    valid = torch.cat([m[:, 1:], torch.zeros((b, 1), dtype=torch.bool,
                                             device=m.device)], dim=1)
    labels = torch.roll(ids, -1, dims=1)     # the wrap at T-1 is masked
    logits = lm_logits(params, tokens, num_heads, remat=remat, mesh=mesh,
                       segment_ids=segment_ids, positions=positions,
                       zigzag=zigzag, pos_type=pos_type)
    per_tok = _token_ce(logits, labels, label_smoothing)
    w = valid.to(per_tok.dtype)
    return (per_tok * w).sum() / torch.clamp(w.sum(), min=1.0)
