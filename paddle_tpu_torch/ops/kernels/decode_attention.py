"""Decode attention — the attention of every serving step
(``models/transformer``'s ``lm_decode_chunk_slots``,
``lm_decode_chunk_paged``, ``lm_decode_step_slots`` and
``lm_decode_step_paged``).

Port of ``paddle_tpu/ops/pallas/decode_attention.py``'s four float32
kernels (same signatures and contracts):

* ``decode_attention_slab_chunk`` — K query lanes per row over the row's
  slab stripe (the default chunked step);
* ``decode_attention_slab`` — one query per row over its slab stripe (the
  legacy ladder's step);
* ``decode_attention_paged_chunk`` / ``decode_attention_paged`` — the
  same two over the shared block pool, each row's K/V found through its
  block table.

The kernels are one template in ``csrc/decode_attention.cu``; each
``*_plain`` function is its kernel's plain PyTorch version, which the CPU
takes and which ``chip_smoke.py`` holds the kernel against on the card.
Each kernel has its own ``launches`` counter.
"""

import ctypes
import math

import torch

from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops.kernels import _build, _check

SOURCE = "paddle_tpu_torch/csrc/decode_attention.cu"
_PALLAS = "paddle_tpu/ops/pallas/decode_attention.py"
NAME = "decode_attention_slab_chunk"
REPLACES = f"{_PALLAS}:605"
NAME_SLAB = "decode_attention_slab"
REPLACES_SLAB = f"{_PALLAS}:454"
NAME_PAGED = "decode_attention_paged"
REPLACES_PAGED = f"{_PALLAS}:530"
NAME_PAGED_CHUNK = "decode_attention_paged_chunk"
REPLACES_PAGED_CHUNK = f"{_PALLAS}:675"

# kernel launches since the last reset, one counter per kernel (bumped
# only where the kernel is launched; the plain versions never count)
launches = 0                 # decode_attention_slab_chunk
launches_slab = 0
launches_paged = 0
launches_paged_chunk = 0

_entries = {}

# C entry -> (pointer args, int args): every entry ends (float scale,
# cudaStream_t)
_SIGNATURES = {"decode_attention_slab_chunk_f32": (5, 6),
               "decode_attention_slab_f32": (5, 5),
               "decode_attention_paged_chunk_f32": (6, 7),
               "decode_attention_paged_f32": (6, 6)}


def _entry(name):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("decode_attention"), name)
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _heads(name, d, dkv, num_heads):
    """(H, Hkv, dh) after checking that D and Dkv split into whole heads
    the kernels take; raises ValueError otherwise."""
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"{name}: num_heads={num_heads} does not divide "
                         f"D={d}")
    dh = d // num_heads
    _check.head_dim(name, dh)
    if dkv % dh or num_heads % (dkv // dh):
        raise ValueError(f"{name}: Dkv={dkv} is not a whole number of "
                         f"KV heads dividing {num_heads} query heads")
    return num_heads, dkv // dh, dh


def _slab_shapes(name, q, k, v, qpos, num_heads):
    """(S, K, T, H, Hkv, dh) for q [S, K, D] (or [S, D] with positions
    [S], as K = 1), k/v [S, T, Dkv], qpos [S, K]."""
    lanes = q.dim() == 3
    if q.dim() not in (2, 3) or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: want q [S, K, D] or [S, D], k/v "
                         f"[S, T, Dkv]; got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    s, d = q.shape[0], q.shape[-1]
    kk = q.shape[1] if lanes else 1
    want = (s, kk) if lanes else (s,)
    t, dkv = k.shape[1], k.shape[2]
    if k.shape[0] != s or tuple(qpos.shape) != want or kk < 1 or t < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"positions {tuple(qpos.shape)} do not describe S "
                         "rows of K >= 1 lanes over a T >= 1 slab")
    return (s, kk, t) + _heads(name, d, dkv, num_heads)


def _paged_shapes(name, q, k, v, qpos, tables, num_heads):
    """(S, K, NB, bs, nb_row, H, Hkv, dh) for q [S, K, D] (or [S, D]),
    the pool k/v [NB, bs, Dkv], qpos [S, K] (or [S]), tables [S, nb_row]."""
    lanes = q.dim() == 3
    if q.dim() not in (2, 3) or k.dim() != 3 or v.shape != k.shape \
            or tables.dim() != 2:
        raise ValueError(f"{name}: want q [S, K, D] or [S, D], pool k/v "
                         f"[NB, bs, Dkv], tables [S, blocks_per_row]; got "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} tables {tuple(tables.shape)}")
    s, d = q.shape[0], q.shape[-1]
    kk = q.shape[1] if lanes else 1
    want = (s, kk) if lanes else (s,)
    nb, bs, dkv = k.shape
    nb_row = tables.shape[1]
    if tuple(qpos.shape) != want or tables.shape[0] != s or kk < 1 \
            or nb < 1 or bs < 1 or nb_row < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)}, positions "
                         f"{tuple(qpos.shape)}, tables "
                         f"{tuple(tables.shape)}, pool {tuple(k.shape)} do "
                         "not describe S rows of K >= 1 lanes over "
                         "non-empty block chains")
    return (s, kk, nb, bs, nb_row) + _heads(name, d, dkv, num_heads)


def _chain(pool, tables, span_end):
    """Each row's chain gathered to a contiguous [S, nb_row * bs, Dkv]
    view, zeroed past the row's last position ``span_end[r]``: the
    kernel never reads those blocks (scratch or stale ids), so neither
    does the result."""
    s, nb_row = tables.shape
    rows = pool[tables.long()].reshape(s, nb_row * pool.shape[1], -1)
    cols = torch.arange(rows.shape[1], device=pool.device)
    keep = cols[None, :] <= span_end[:, None].long()
    return torch.where(keep[..., None], rows, torch.zeros_like(rows))


def _masked(q, k, v, qpos, num_heads):
    """Lane (r, i) of q [S, K, D] attends k/v [S, T, Dkv] at cols <=
    qpos[r, i]; rows whose lanes all repeat lane 0's position (a decode
    row) give exact zeros on lanes 1..K-1, as the kernel writes them."""
    s, kk, d = q.shape
    t, dkv = k.shape[1], k.shape[2]
    h = num_heads
    dh = d // h
    hkv = dkv // dh
    qh = q.reshape(s, kk, h, dh).transpose(1, 2)
    kh = attn_ops.repeat_kv_heads(k.reshape(s, t, hkv, dh).transpose(1, 2),
                                  h)
    vh = attn_ops.repeat_kv_heads(v.reshape(s, t, hkv, dh).transpose(1, 2),
                                  h)
    cols = torch.arange(t, device=q.device)
    mask = cols[None, None, :] <= qpos[:, :, None].long()      # [S, K, T]
    out = attn_ops.dot_product_attention(qh, kh, vh, mask=mask[:, None])
    out = out.transpose(1, 2).reshape(s, kk, h * dh)
    decode_row = qpos[:, kk - 1] == qpos[:, 0]
    live = (torch.arange(kk, device=q.device)[None, :] == 0) \
        | ~decode_row[:, None]
    return torch.where(live[..., None], out, torch.zeros_like(out))


# ------------------------------------------------------------- plain versions

def decode_attention_slab_chunk_plain(q, k, v, qpos, num_heads):
    """The contract written as masked softmax attention: lane (r, i)
    attends row r's stripe at cols <= qpos[r, i]; a decode row's lanes
    1..K-1 are exact zeros, as the kernel's fast path writes them."""
    _slab_shapes(NAME, q, k, v, qpos, num_heads)
    return _masked(q, k, v, qpos, num_heads)


def decode_attention_slab_plain(q, k, v, positions, num_heads):
    """Row r's one query attends its stripe at cols <= positions[r]."""
    _slab_shapes(NAME_SLAB, q, k, v, positions, num_heads)
    return _masked(q[:, None], k, v, positions[:, None], num_heads)[:, 0]


def decode_attention_paged_chunk_plain(q, k, v, qpos, tables, num_heads):
    """``decode_attention_slab_chunk_plain`` over each row's block chain
    ``pool[tables[r]]``, read up to the row's furthest lane."""
    _paged_shapes(NAME_PAGED_CHUNK, q, k, v, qpos, tables, num_heads)
    end = qpos[:, -1]
    return _masked(q, _chain(k, tables, end), _chain(v, tables, end), qpos,
                   num_heads)


def decode_attention_paged_plain(q, k, v, positions, tables, num_heads):
    """``decode_attention_slab_plain`` over each row's block chain."""
    _paged_shapes(NAME_PAGED, q, k, v, positions, tables, num_heads)
    return _masked(q[:, None], _chain(k, tables, positions),
                   _chain(v, tables, positions), positions[:, None],
                   num_heads)[:, 0]


# ------------------------------------------------------------- wrappers

_F32, _I32 = torch.float32, torch.int32


def _launch(entry, *args):
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    _build.check(entry, _entry(entry)(*ptrs, stream))


def decode_attention_slab_chunk(q, k, v, qpos, num_heads):
    """q [S, K, D] f32, k/v [S, T, Dkv] f32 (the cache, already holding
    this step's writes), qpos [S, K] int32 per-lane positions
    (non-decreasing per row) -> [S, K, D].  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    global launches
    dev = _check.tensors(NAME, {"q": _F32, "k": _F32, "v": _F32,
                                "qpos": _I32}, q=q, k=k, v=v, qpos=qpos)
    s, kk, t, h, hkv, dh = _slab_shapes(NAME, q, k, v, qpos, num_heads)
    if dev.type == "cpu":
        return decode_attention_slab_chunk_plain(q, k, v, qpos, num_heads)
    out = torch.empty_like(q)
    _launch("decode_attention_slab_chunk_f32", q, k, v, qpos, out, s, kk, t,
            h, hkv, dh, 1.0 / math.sqrt(dh))
    launches += 1
    return out


def decode_attention_slab(q, k, v, positions, num_heads):
    """q [S, D] f32, k/v [S, T, Dkv] f32, positions [S] int32 -> [S, D]:
    row r's query attends its stripe at cols <= positions[r]."""
    global launches_slab
    dev = _check.tensors(NAME_SLAB, {"q": _F32, "k": _F32, "v": _F32,
                                     "positions": _I32},
                         q=q, k=k, v=v, positions=positions)
    s, _kk, t, h, hkv, dh = _slab_shapes(NAME_SLAB, q, k, v, positions,
                                         num_heads)
    if dev.type == "cpu":
        return decode_attention_slab_plain(q, k, v, positions, num_heads)
    out = torch.empty_like(q)
    _launch("decode_attention_slab_f32", q, k, v, positions, out, s, t, h,
            hkv, dh, 1.0 / math.sqrt(dh))
    launches_slab += 1
    return out


def decode_attention_paged_chunk(q, k, v, qpos, tables, num_heads):
    """q [S, K, D] f32, the pool k/v [NB, bs, Dkv] f32 (already holding
    this step's writes), qpos [S, K] int32, tables [S, blocks_per_row]
    int32 physical block ids -> [S, K, D].  Row r's position p lives at
    ``pool[tables[r, p // bs], p % bs]``; the kernel walks the table up
    to the row's furthest lane only."""
    global launches_paged_chunk
    dev = _check.tensors(NAME_PAGED_CHUNK,
                         {"q": _F32, "k": _F32, "v": _F32, "qpos": _I32,
                          "tables": _I32},
                         q=q, k=k, v=v, qpos=qpos, tables=tables)
    s, kk, _nb, bs, nb_row, h, hkv, dh = _paged_shapes(
        NAME_PAGED_CHUNK, q, k, v, qpos, tables, num_heads)
    if dev.type == "cpu":
        return decode_attention_paged_chunk_plain(q, k, v, qpos, tables,
                                                  num_heads)
    out = torch.empty_like(q)
    _launch("decode_attention_paged_chunk_f32", q, k, v, qpos, tables, out,
            s, kk, bs, nb_row, h, hkv, dh, 1.0 / math.sqrt(dh))
    launches_paged_chunk += 1
    return out


def decode_attention_paged(q, k, v, positions, tables, num_heads):
    """q [S, D] f32, the pool k/v [NB, bs, Dkv], positions [S] int32,
    tables [S, blocks_per_row] int32 -> [S, D]."""
    global launches_paged
    dev = _check.tensors(NAME_PAGED,
                         {"q": _F32, "k": _F32, "v": _F32,
                          "positions": _I32, "tables": _I32},
                         q=q, k=k, v=v, positions=positions, tables=tables)
    s, _kk, _nb, bs, nb_row, h, hkv, dh = _paged_shapes(
        NAME_PAGED, q, k, v, positions, tables, num_heads)
    if dev.type == "cpu":
        return decode_attention_paged_plain(q, k, v, positions, tables,
                                            num_heads)
    out = torch.empty_like(q)
    _launch("decode_attention_paged_f32", q, k, v, positions, tables, out,
            s, bs, nb_row, h, hkv, dh, 1.0 / math.sqrt(dh))
    launches_paged += 1
    return out
