"""Reader/writer for the reference's binary proto data format
(a copy of ``paddle_tpu/data/proto_format.py``, which imports no JAX; the
port keeps its own).

Reference: proto/DataFormat.proto:1 (DataHeader / DataSample / VectorSlot /
SubseqSlot) framed as varint32-length-delimited proto2 messages
(gserver/dataproviders/ProtoReader.h:95-102: ReadVarint32 then a
PushLimit'd ParseFromCodedStream), gzip-wrapped when the filename ends in
.gz (ProtoDataProvider.cpp:213).  First message is the DataHeader; every
following message is one DataSample.

Implemented directly on the proto2 wire format (the three messages use
only varint, fixed32-packed and length-delimited fields), so reference
data files are readable without protoc or generated bindings.

Slot payloads per SlotType (DataFormat.proto:44-55):
  VECTOR_DENSE            -> float32[dim]
  VECTOR_SPARSE_NON_VALUE -> uint32 id list
  VECTOR_SPARSE_VALUE     -> (ids, values) pair of equal-length lists
  INDEX                   -> int
  VAR_MDIM_DENSE          -> float32 array reshaped to dims (if given)
  VAR_MDIM_INDEX          -> uint32 id list (from var_id_slots)
  STRING                  -> str
"""

import gzip
import struct

import numpy as np

from paddle_tpu_torch.utils.error import ConfigError

# SlotDef.SlotType (DataFormat.proto:45-53)
VECTOR_DENSE = 0
VECTOR_SPARSE_NON_VALUE = 1
VECTOR_SPARSE_VALUE = 2
INDEX = 3
VAR_MDIM_DENSE = 4
VAR_MDIM_INDEX = 5
STRING = 6

_WIRE_VARINT = 0
_WIRE_F64 = 1
_WIRE_LEN = 2
_WIRE_F32 = 5


# --------------------------------------------------------------- wire level

def _read_varint(buf, pos):
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ConfigError("proto data: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ConfigError("proto data: varint too long")


def _write_varint(out, value):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(buf):
    """Iterate (field_number, wire_type, value) over a message buffer.
    LEN fields yield memoryview payloads; varints yield ints; F32 raw."""
    pos = 0
    mv = memoryview(buf)
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise ConfigError("proto data: truncated field payload")
            val = mv[pos:pos + n]
            pos += n
        elif wire == _WIRE_F32:
            if pos + 4 > len(buf):
                raise ConfigError("proto data: truncated fixed32 field")
            val = mv[pos:pos + 4]
            pos += 4
        elif wire == _WIRE_F64:
            if pos + 8 > len(buf):
                raise ConfigError("proto data: truncated fixed64 field")
            val = mv[pos:pos + 8]
            pos += 8
        else:
            raise ConfigError(f"proto data: unsupported wire type {wire}")
        yield field, wire, val


def _packed_varints(payload):
    out, pos = [], 0
    buf = bytes(payload)
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _packed_floats(payload):
    buf = bytes(payload)
    if len(buf) % 4:
        raise ConfigError(
            f"proto data: packed float payload of {len(buf)} bytes is not "
            "a multiple of 4")
    return np.frombuffer(buf, "<f4").copy()


# ------------------------------------------------------------ message level

def _parse_vector_slot(buf):
    values, ids, dims, strs = [], [], [], []
    for field, wire, val in _fields(buf):
        if field == 1:      # values: packed float (or unpacked f32)
            values.extend(_packed_floats(val) if wire == _WIRE_LEN
                          else [struct.unpack("<f", bytes(val))[0]])
        elif field == 2:    # ids: packed uint32
            ids.extend(_packed_varints(val) if wire == _WIRE_LEN else [val])
        elif field == 3:    # dims
            dims.extend(_packed_varints(val) if wire == _WIRE_LEN else [val])
        elif field == 4:    # strs
            strs.append(bytes(val).decode("utf-8", errors="replace"))
    return {"values": np.asarray(values, np.float32), "ids": ids,
            "dims": dims, "strs": strs}


def _parse_subseq_slot(buf):
    slot_id, lens = None, []
    for field, wire, val in _fields(buf):
        if field == 1:
            slot_id = val
        elif field == 2:
            lens.extend(_packed_varints(val) if wire == _WIRE_LEN else [val])
    return {"slot_id": slot_id, "lens": lens}


def parse_header(buf):
    """DataHeader -> [(type, dim), ...]."""
    slot_defs = []
    for field, _wire, val in _fields(buf):
        if field == 1:
            t = d = None
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:
                    t = v2
                elif f2 == 2:
                    d = v2
            if t is None or d is None:
                raise ConfigError("proto data: SlotDef missing type/dim")
            slot_defs.append((t, d))
    if not slot_defs:
        raise ConfigError("proto data: header defines no slots")
    return slot_defs


def parse_sample(buf):
    sample = {"is_beginning": True, "vector_slots": [], "id_slots": [],
              "var_id_slots": [], "subseq_slots": []}
    for field, wire, val in _fields(buf):
        if field == 1:
            sample["is_beginning"] = bool(val)
        elif field == 2:
            sample["vector_slots"].append(_parse_vector_slot(val))
        elif field == 3:
            sample["id_slots"].extend(
                _packed_varints(val) if wire == _WIRE_LEN else [val])
        elif field == 4:
            sample["var_id_slots"].append(_parse_vector_slot(val))
        elif field == 5:
            sample["subseq_slots"].append(_parse_subseq_slot(val))
    return sample


# --------------------------------------------------------------- file level

def _open(path, mode="rb"):
    return gzip.open(path, mode) if str(path).endswith(".gz") \
        else open(path, mode)


def _read_messages(f):
    """Yield varint32-delimited message buffers (ProtoReader framing)."""
    while True:
        # read the varint byte-by-byte: the stream has no lookahead
        size = shift = 0
        first = f.read(1)
        if not first:
            return
        b = first[0]
        while True:
            size |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            nxt = f.read(1)
            if not nxt:
                raise ConfigError("proto data: truncated message size")
            b = nxt[0]
        buf = f.read(size)
        if len(buf) < size:
            raise ConfigError(
                f"proto data: truncated message ({len(buf)}/{size} bytes)")
        yield buf


def _slot_value(slot_type, dim, vec):
    if slot_type == VECTOR_DENSE:
        v = vec["values"]
        if len(v) != dim:
            raise ConfigError(
                f"proto data: dense slot expects {dim} values, got {len(v)}")
        return v
    if slot_type == VECTOR_SPARSE_NON_VALUE:
        return list(vec["ids"])
    if slot_type == VECTOR_SPARSE_VALUE:
        return list(vec["ids"]), list(np.asarray(vec["values"]))
    if slot_type == STRING:
        return vec["strs"][0] if vec["strs"] else ""
    if slot_type == VAR_MDIM_DENSE:
        v = vec["values"]
        return v.reshape(vec["dims"]) if vec["dims"] else v
    raise ConfigError(f"proto data: unhandled slot type {slot_type}")


class ProtoDataFile:
    """One reference data file: .slot_defs [(type, dim)], iter -> samples.

    Iteration yields (values, is_beginning) where values is a tuple with
    one entry per header slot, decoded per the table in the module
    docstring — the shape PyDataProvider2-style readers expect."""

    def __init__(self, path):
        self.path = path
        with _open(path) as f:
            msgs = _read_messages(f)
            try:
                header_buf = next(msgs)
            except StopIteration:
                raise ConfigError(f"proto data {path!r}: empty file")
            self.slot_defs = parse_header(header_buf)

    def __iter__(self):
        n_vec = sum(1 for t, _ in self.slot_defs
                    if t in (VECTOR_DENSE, VECTOR_SPARSE_NON_VALUE,
                             VECTOR_SPARSE_VALUE, VAR_MDIM_DENSE, STRING))
        with _open(self.path) as f:
            msgs = _read_messages(f)
            next(msgs)                      # header
            for buf in msgs:
                s = parse_sample(buf)
                if len(s["vector_slots"]) != n_vec:
                    raise ConfigError(
                        f"proto data {self.path!r}: sample has "
                        f"{len(s['vector_slots'])} vector slots, header "
                        f"declares {n_vec}")
                n_idx = sum(1 for t, _ in self.slot_defs if t == INDEX)
                n_var = sum(1 for t, _ in self.slot_defs
                            if t == VAR_MDIM_INDEX)
                if len(s["id_slots"]) < n_idx \
                        or len(s["var_id_slots"]) < n_var:
                    raise ConfigError(
                        f"proto data {self.path!r}: sample has "
                        f"{len(s['id_slots'])} id / "
                        f"{len(s['var_id_slots'])} var-id slots, header "
                        f"declares {n_idx} INDEX / {n_var} VAR_MDIM_INDEX")
                values = []
                vec_i = idx_i = var_i = 0
                for t, dim in self.slot_defs:
                    if t == INDEX:
                        values.append(int(s["id_slots"][idx_i]))
                        idx_i += 1
                    elif t == VAR_MDIM_INDEX:
                        values.append(list(s["var_id_slots"][var_i]["ids"]))
                        var_i += 1
                    else:
                        values.append(_slot_value(
                            t, dim, s["vector_slots"][vec_i]))
                        vec_i += 1
                yield tuple(values), s["is_beginning"]


def reader_creator(paths):
    """PyDataProvider2-style reader over reference proto data files: yields
    one tuple per SAMPLE (callers needing sequence grouping use
    is_beginning via ProtoDataFile directly)."""
    if isinstance(paths, str):
        paths = [paths]

    def reader():
        for p in paths:
            for values, _beg in ProtoDataFile(p):
                yield values
    return reader


# ------------------------------------------------------------------ writer

def _tag(field, wire):
    return (field << 3) | wire


def _emit_len_field(out, field, payload):
    _write_varint(out, _tag(field, _WIRE_LEN))
    _write_varint(out, len(payload))
    out.extend(payload)


def _emit_vector_slot(values=(), ids=(), dims=(), strs=()):
    out = bytearray()
    if len(values):
        _emit_len_field(out, 1, np.asarray(values, "<f4").tobytes())
    if len(ids):
        pk = bytearray()
        for i in ids:
            _write_varint(pk, int(i))
        _emit_len_field(out, 2, pk)
    if len(dims):
        pk = bytearray()
        for d in dims:
            _write_varint(pk, int(d))
        _emit_len_field(out, 3, pk)
    for s in strs:
        _emit_len_field(out, 4, s.encode("utf-8"))
    return out


def _encode_sample(slot_defs, values, is_beginning):
    msg = bytearray()
    if not is_beginning:
        _write_varint(msg, _tag(1, _WIRE_VARINT))
        _write_varint(msg, 0)
    id_slots = []
    for (t, dim), v in zip(slot_defs, values):
        if t == INDEX:
            id_slots.append(int(v))
        elif t == VAR_MDIM_INDEX:
            _emit_len_field(msg, 4, _emit_vector_slot(ids=v))
        elif t == VECTOR_DENSE:
            _emit_len_field(msg, 2, _emit_vector_slot(values=v))
        elif t == VECTOR_SPARSE_NON_VALUE:
            _emit_len_field(msg, 2, _emit_vector_slot(ids=v))
        elif t == VECTOR_SPARSE_VALUE:
            ids, vals = v
            _emit_len_field(msg, 2, _emit_vector_slot(values=vals, ids=ids))
        elif t == VAR_MDIM_DENSE:
            arr = np.asarray(v, np.float32)
            _emit_len_field(msg, 2, _emit_vector_slot(
                values=arr.reshape(-1), dims=arr.shape))
        elif t == STRING:
            _emit_len_field(msg, 2, _emit_vector_slot(strs=[v]))
        else:
            raise ConfigError(f"write_proto_data: bad slot type {t}")
    if id_slots:
        pk = bytearray()
        for i in id_slots:
            _write_varint(pk, i)
        _emit_len_field(msg, 3, pk)
    return msg


def write_proto_data(path, slot_defs, samples):
    """Write a reference-format data file (for tests and for migrating data
    INTO the reference toolchain).  slot_defs: [(type, dim)]; samples:
    iterable of (values_tuple, is_beginning) shaped like ProtoDataFile
    iteration output.  Samples stream to disk one message at a time, so
    memory stays bounded by a single sample regardless of dataset size."""
    header = bytearray()
    for t, dim in slot_defs:
        sd = bytearray()
        _write_varint(sd, _tag(1, _WIRE_VARINT))
        _write_varint(sd, t)
        _write_varint(sd, _tag(2, _WIRE_VARINT))
        _write_varint(sd, dim)
        _emit_len_field(header, 1, sd)

    with _open(path, "wb") as f:
        def emit(msg):
            size = bytearray()
            _write_varint(size, len(msg))
            f.write(bytes(size))
            f.write(bytes(msg))
        emit(header)
        for values, is_beginning in samples:
            emit(_encode_sample(slot_defs, values, is_beginning))
