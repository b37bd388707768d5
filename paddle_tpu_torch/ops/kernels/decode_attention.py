"""Decode attention — the attention of every serving step
(``models/transformer``'s ``lm_decode_chunk_slots``,
``lm_decode_chunk_paged``, ``lm_decode_step_slots`` and
``lm_decode_step_paged``).

Port of ``paddle_tpu/ops/pallas/decode_attention.py``'s four kernels
(same signatures and contracts), each over a float32 cache or, given the
keyword operands ``kscale``/``vscale``, an int8 one
(``quant/kv.py``: int8 codes plus f32 scales per (position, KV head)):

* ``decode_attention_slab_chunk`` — K query lanes per row over the row's
  slab stripe (the default chunked step);
* ``decode_attention_slab`` — one query per row over its slab stripe (the
  legacy ladder's step);
* ``decode_attention_paged_chunk`` / ``decode_attention_paged`` — the
  same two over the shared block pool, each row's K/V found through its
  block table.

The kernels live in ``csrc/decode_attention.cu``: the two chunked ones
split each row's span across CTAs (split-KV) and merge the splits in
the same launch, the last CTA of a row's (KV head, vector group) found
by a ticket; their wrappers pass the device's scratch and zeroed
tickets.  Each
``*_plain`` function is its kernel's plain PyTorch version, which the CPU
takes and which ``chip_smoke.py`` holds the kernel against on the card
(an int8 cache is dequantized with ``quant/kv.dequantize_heads`` first,
the product the int8 kernels form in registers).  Each kernel, float32
and int8, has its own ``launches`` counter.

Head dims: any up to 128 and the multiples of 128 up to ``MAX_HEAD_DIM``
-- the TPU kernels' lane-tileable widths (JAX's ``_mosaic_ok``); the
kernel pads a head to its compiled width.  ``covers`` is the route's
rule, JAX's ``covers``: where it fails the model attends through its
masked plain path, as the reference does.
"""

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops.kernels import _build, _check
from paddle_tpu_torch.quant.kv import dequantize_heads

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
# the int8-cache instances of the same four (one pallas_call each on the
# TPU, with the kscale/vscale operands)
NAME_I8 = f"{NAME}_int8"
NAME_SLAB_I8 = f"{NAME_SLAB}_int8"
NAME_PAGED_I8 = f"{NAME_PAGED}_int8"
NAME_PAGED_CHUNK_I8 = f"{NAME_PAGED_CHUNK}_int8"

# kernel launches since the last reset, one counter per kernel (bumped
# only where the kernel is launched; the plain versions never count)
launches = 0                 # decode_attention_slab_chunk
launches_slab = 0
launches_paged = 0
launches_paged_chunk = 0
launches_i8 = 0              # decode_attention_slab_chunk, int8 cache
launches_slab_i8 = 0
launches_paged_i8 = 0
launches_paged_chunk_i8 = 0

# C entry -> (pointer args, int args): every entry ends (float scale,
# cudaStream_t); an _i8 entry takes the two scale pointers after k/v, a
# chunked entry its scratch and tickets after out
_SIGNATURES = {"decode_attention_slab_chunk_f32": (7, 6),
               "decode_attention_slab_f32": (5, 5),
               "decode_attention_paged_chunk_f32": (8, 7),
               "decode_attention_paged_f32": (6, 6),
               "decode_attention_slab_chunk_i8": (9, 6),
               "decode_attention_slab_i8": (7, 5),
               "decode_attention_paged_chunk_i8": (10, 7),
               "decode_attention_paged_i8": (8, 6)}


# the widest head the kernels compile (shared memory: 148 KB a CTA)
MAX_HEAD_DIM = 512


def head_dim_ok(dh):
    """A head width the kernels take: 1..128, or a multiple of 128 up to
    ``MAX_HEAD_DIM``."""
    return 1 <= dh <= MAX_HEAD_DIM and _check.lane_tileable(dh)


def covers(num_heads, d, dkv, block_size=None):
    """JAX's dispatch predicate (``decode_attention.py:699-734``) for the
    port's kernels: the widths split into grouped heads of a width the
    kernels take and, on the paged layout (``block_size`` given), a
    lane-tileable block.  Where it fails, ``models/transformer`` attends
    through ``_attend``, as the reference does."""
    if num_heads < 1 or d % num_heads:
        return False
    dh = d // num_heads
    if dh < 1 or dkv % dh or dkv // dh < 1 or num_heads % (dkv // dh):
        return False
    if block_size is not None and not _check.lane_tileable(block_size):
        return False
    return head_dim_ok(dh)


def _entry(name):
    return _build.entry("decode_attention", name, *_SIGNATURES[name],
                        ctypes.c_float)


def _heads(name, d, dkv, num_heads):
    """(H, Hkv, dh) after checking that D and Dkv split into whole heads
    the kernels take; raises ValueError otherwise."""
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"{name}: num_heads={num_heads} does not divide "
                         f"D={d}")
    dh = d // num_heads
    if not head_dim_ok(dh):
        raise ValueError(f"{name}: head dim {dh} is not one the kernels "
                         f"take (up to 128, or a multiple of 128 up to "
                         f"{MAX_HEAD_DIM})")
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


def _check_scales(name, kscale, vscale, k, v, hkv):
    """True when ``kscale``/``vscale`` mark an int8 cache (JAX's
    ``_check_scales``): both or neither, each shaped as k/v with Hkv in
    place of Dkv, k/v int8.  Raises ValueError otherwise."""
    if kscale is None and vscale is None:
        return False
    if kscale is None or vscale is None:
        raise ValueError(f"{name}: kscale and vscale come together")
    want = tuple(k.shape[:-1]) + (hkv,)
    if tuple(kscale.shape) != want or tuple(vscale.shape) != want:
        raise ValueError(f"{name}: scale sidecars must be {want}, got "
                         f"{tuple(kscale.shape)}/{tuple(vscale.shape)}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{name}: k/v must be int8 beside scale sidecars, "
                         f"got {k.dtype}/{v.dtype}")
    return True


def _widen(k, v, kscale, vscale):
    """The float32 K/V the kernels attend: an int8 cache dequantized."""
    if kscale is None:
        return k, v
    return dequantize_heads(k, kscale), dequantize_heads(v, vscale)


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

def decode_attention_slab_chunk_plain(q, k, v, qpos, num_heads, *,
                                      kscale=None, vscale=None):
    """The contract written as masked softmax attention: lane (r, i)
    attends row r's stripe at cols <= qpos[r, i]; a decode row's lanes
    1..K-1 are exact zeros, as the kernel's fast path writes them."""
    hkv = _slab_shapes(NAME, q, k, v, qpos, num_heads)[4]
    _check_scales(NAME, kscale, vscale, k, v, hkv)
    return _masked(q, *_widen(k, v, kscale, vscale), qpos, num_heads)


def decode_attention_slab_plain(q, k, v, positions, num_heads, *,
                                kscale=None, vscale=None):
    """Row r's one query attends its stripe at cols <= positions[r]."""
    hkv = _slab_shapes(NAME_SLAB, q, k, v, positions, num_heads)[4]
    _check_scales(NAME_SLAB, kscale, vscale, k, v, hkv)
    return _masked(q[:, None], *_widen(k, v, kscale, vscale),
                   positions[:, None], num_heads)[:, 0]


def decode_attention_paged_chunk_plain(q, k, v, qpos, tables, num_heads, *,
                                       kscale=None, vscale=None):
    """``decode_attention_slab_chunk_plain`` over each row's block chain
    ``pool[tables[r]]``, read up to the row's furthest lane."""
    hkv = _paged_shapes(NAME_PAGED_CHUNK, q, k, v, qpos, tables,
                        num_heads)[6]
    _check_scales(NAME_PAGED_CHUNK, kscale, vscale, k, v, hkv)
    k, v = _widen(k, v, kscale, vscale)
    end = qpos[:, -1]
    return _masked(q, _chain(k, tables, end), _chain(v, tables, end), qpos,
                   num_heads)


def decode_attention_paged_plain(q, k, v, positions, tables, num_heads, *,
                                 kscale=None, vscale=None):
    """``decode_attention_slab_plain`` over each row's block chain."""
    hkv = _paged_shapes(NAME_PAGED, q, k, v, positions, tables,
                        num_heads)[6]
    _check_scales(NAME_PAGED, kscale, vscale, k, v, hkv)
    k, v = _widen(k, v, kscale, vscale)
    return _masked(q[:, None], _chain(k, tables, positions),
                   _chain(v, tables, positions), positions[:, None],
                   num_heads)[:, 0]


# ------------------------------------------------------------- wrappers

_F32, _I32 = torch.float32, torch.int32
_DTYPES = {"q": _F32, "qpos": _I32, "positions": _I32, "tables": _I32,
           "kscale": _F32, "vscale": _F32}


def _device(name, quant, **named):
    """Check every operand given (one device, dtype, contiguous, 16-byte
    aligned): k/v int8 on an int8 cache, float32 otherwise.  Returns the
    device."""
    kv = torch.int8 if quant else _F32
    return _check.tensors(name, dict(_DTYPES, k=kv, v=kv),
                          **{a: t for a, t in named.items() if t is not None})


# The chunked kernels' operands beside their inputs, one of each per
# device, made or grown on the first call that needs them: the scratch
# (each launch writes its own records before it reads them) and the
# tickets (zeroed once; every launch leaves them all 0, the last CTA of
# each row's (KV head, vector group) resetting its own).  So two launches
# on one device must not run at once on two streams (every caller here
# launches on one).  An outgrown buffer is kept: a captured CUDA graph
# may still point at it.
_scratch = {}
_tickets = {}
_outgrown = []


def _count(name, *ints):
    """An int the library computes from shapes (its C entry ``name``)."""
    fn = getattr(_build.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(ints)
        fn.restype = ctypes.c_longlong
    return fn(*ints)


@functools.lru_cache(maxsize=256)
def _split_sizes(s, kk, span, h, hkv, dh):
    """(scratch floats, tickets) of a chunked launch at these shapes."""
    return (_count("decode_attention_chunk_scratch", s, kk, span, h, hkv,
                   dh),
            _count("decode_attention_chunk_tickets", s, kk, h, hkv))


def _buffer(store, name, dev, n, dtype, make):
    """``store``'s buffer for ``dev``, of at least ``n`` elements."""
    buf = store.get(dev.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: its buffers would grow during a "
                               "CUDA graph capture; call it once at these "
                               "shapes before capturing")
        if buf is not None:
            _outgrown.append(buf)
        buf = make(max(n, 1024), dtype=dtype, device=dev)
        store[dev.index] = buf
    return buf


def _split_operands(name, dev, s, kk, span, h, hkv, dh):
    """(scratch, tickets) of a chunked launch: this device's buffers; no
    scratch (None) where one split covers the span."""
    n, need = _split_sizes(s, kk, span, h, hkv, dh)
    part = (_buffer(_scratch, name, dev, n, _F32, torch.empty) if n > 0
            else None)
    return part, _buffer(_tickets, name, dev, need, _I32, torch.zeros)


def _launch(entry, *args):
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    _build.check(entry, _entry(entry)(*ptrs, stream))


def decode_attention_slab_chunk(q, k, v, qpos, num_heads, *, kscale=None,
                                vscale=None):
    """q [S, K, D] f32, k/v [S, T, Dkv] (the cache, already holding this
    step's writes), qpos [S, K] int32 per-lane positions (non-decreasing
    per row) -> [S, K, D].  k/v float32, or int8 with kscale/vscale
    [S, T, Hkv] f32.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    global launches, launches_i8
    s, kk, t, h, hkv, dh = _slab_shapes(NAME, q, k, v, qpos, num_heads)
    quant = _check_scales(NAME, kscale, vscale, k, v, hkv)
    dev = _device(NAME, quant, q=q, k=k, v=v, qpos=qpos, kscale=kscale,
                  vscale=vscale)
    if dev.type == "cpu":
        return decode_attention_slab_chunk_plain(
            q, k, v, qpos, num_heads, kscale=kscale, vscale=vscale)
    out = torch.empty_like(q)
    part, tickets = _split_operands(NAME, dev, s, kk, t, h, hkv, dh)
    scale = 1.0 / math.sqrt(dh)
    if quant:
        _launch("decode_attention_slab_chunk_i8", q, k, v, kscale, vscale,
                qpos, out, part, tickets, s, kk, t, h, hkv, dh, scale)
        launches_i8 += 1
    else:
        _launch("decode_attention_slab_chunk_f32", q, k, v, qpos, out, part,
                tickets, s, kk, t, h, hkv, dh, scale)
        launches += 1
    return out


def decode_attention_slab(q, k, v, positions, num_heads, *, kscale=None,
                          vscale=None):
    """q [S, D] f32, k/v [S, T, Dkv] (float32, or int8 with kscale/vscale
    [S, T, Hkv]), positions [S] int32 -> [S, D]: row r's query attends
    its stripe at cols <= positions[r]."""
    global launches_slab, launches_slab_i8
    s, _kk, t, h, hkv, dh = _slab_shapes(NAME_SLAB, q, k, v, positions,
                                         num_heads)
    quant = _check_scales(NAME_SLAB, kscale, vscale, k, v, hkv)
    dev = _device(NAME_SLAB, quant, q=q, k=k, v=v, positions=positions,
                  kscale=kscale, vscale=vscale)
    if dev.type == "cpu":
        return decode_attention_slab_plain(q, k, v, positions, num_heads,
                                           kscale=kscale, vscale=vscale)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dh)
    if quant:
        _launch("decode_attention_slab_i8", q, k, v, kscale, vscale,
                positions, out, s, t, h, hkv, dh, scale)
        launches_slab_i8 += 1
    else:
        _launch("decode_attention_slab_f32", q, k, v, positions, out, s, t,
                h, hkv, dh, scale)
        launches_slab += 1
    return out


def decode_attention_paged_chunk(q, k, v, qpos, tables, num_heads, *,
                                 kscale=None, vscale=None):
    """q [S, K, D] f32, the pool k/v [NB, bs, Dkv] (already holding this
    step's writes; float32, or int8 with kscale/vscale [NB, bs, Hkv]),
    qpos [S, K] int32, tables [S, blocks_per_row] int32 physical block
    ids -> [S, K, D].  Row r's position p lives at ``pool[tables[r, p //
    bs], p % bs]``; the kernel walks the table up to the row's furthest
    lane only, the scale pool along with it."""
    global launches_paged_chunk, launches_paged_chunk_i8
    s, kk, _nb, bs, nb_row, h, hkv, dh = _paged_shapes(
        NAME_PAGED_CHUNK, q, k, v, qpos, tables, num_heads)
    quant = _check_scales(NAME_PAGED_CHUNK, kscale, vscale, k, v, hkv)
    dev = _device(NAME_PAGED_CHUNK, quant, q=q, k=k, v=v, qpos=qpos,
                  tables=tables, kscale=kscale, vscale=vscale)
    if dev.type == "cpu":
        return decode_attention_paged_chunk_plain(
            q, k, v, qpos, tables, num_heads, kscale=kscale, vscale=vscale)
    out = torch.empty_like(q)
    part, tickets = _split_operands(NAME_PAGED_CHUNK, dev, s, kk,
                                    nb_row * bs, h, hkv, dh)
    scale = 1.0 / math.sqrt(dh)
    if quant:
        _launch("decode_attention_paged_chunk_i8", q, k, v, kscale, vscale,
                qpos, tables, out, part, tickets, s, kk, bs, nb_row, h, hkv,
                dh, scale)
        launches_paged_chunk_i8 += 1
    else:
        _launch("decode_attention_paged_chunk_f32", q, k, v, qpos, tables,
                out, part, tickets, s, kk, bs, nb_row, h, hkv, dh, scale)
        launches_paged_chunk += 1
    return out


def decode_attention_paged(q, k, v, positions, tables, num_heads, *,
                           kscale=None, vscale=None):
    """q [S, D] f32, the pool k/v [NB, bs, Dkv] (float32, or int8 with
    kscale/vscale [NB, bs, Hkv]), positions [S] int32, tables [S,
    blocks_per_row] int32 -> [S, D]."""
    global launches_paged, launches_paged_i8
    s, _kk, _nb, bs, nb_row, h, hkv, dh = _paged_shapes(
        NAME_PAGED, q, k, v, positions, tables, num_heads)
    quant = _check_scales(NAME_PAGED, kscale, vscale, k, v, hkv)
    dev = _device(NAME_PAGED, quant, q=q, k=k, v=v, positions=positions,
                  tables=tables, kscale=kscale, vscale=vscale)
    if dev.type == "cpu":
        return decode_attention_paged_plain(q, k, v, positions, tables,
                                            num_heads, kscale=kscale,
                                            vscale=vscale)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dh)
    if quant:
        _launch("decode_attention_paged_i8", q, k, v, kscale, vscale,
                positions, tables, out, s, bs, nb_row, h, hkv, dh, scale)
        launches_paged_i8 += 1
    else:
        _launch("decode_attention_paged_f32", q, k, v, positions, tables,
                out, s, bs, nb_row, h, hkv, dh, scale)
        launches_paged += 1
    return out
