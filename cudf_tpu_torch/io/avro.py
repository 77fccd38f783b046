"""Avro Object Container File reader and writer (counterpart of
``cudf_tpu/io/avro.py``, whose pure-Python codec is copied here: the port
imports nothing of the reference).

Analog of cpp/src/io/avro/. Decode is a per-value varint walk on the host,
as in the reference, and each column reaches the device with one copy.

Supported schema subset (covers the reference's test corpus): records of
null / boolean / int / long / float / double / string / bytes / enum,
nullable unions ``["null", T]`` in either order, and the null/deflate
codecs.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.column import Column, resolve_device
from ..core.dtypes import Kind
from ..core.table import Table

_MAGIC = b"Obj\x01"


# ---------------------------------------------------------------- primitives
def _read_long(buf: memoryview, pos: int) -> Tuple[int, int]:
    """zigzag varint"""
    b = buf[pos]
    if b < 0x80:  # one byte: -64..63
        return (b >> 1) ^ -(b & 1), pos + 1
    acc = b & 0x7F
    shift = 7
    pos += 1
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos


def _read_bytes(buf, pos):
    n, pos = _read_long(buf, pos)
    return bytes(buf[pos : pos + n]), pos + n


_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


def _decoder(schema):
    """A function (buf, pos) -> (value, next pos) for one field's schema,
    built once a file: the per-value walk then makes no type tests."""
    if isinstance(schema, dict):
        if schema["type"] == "enum":
            symbols = schema["symbols"]

            def enum(buf, pos):
                i, pos = _read_long(buf, pos)
                return symbols[i], pos
            return enum
        schema = schema["type"]
    if isinstance(schema, list):  # union
        branches = [_decoder(s) for s in schema]

        def union(buf, pos):
            i, pos = _read_long(buf, pos)
            return branches[i](buf, pos)
        return union
    if schema == "null":
        return lambda buf, pos: (None, pos)
    if schema == "boolean":
        return lambda buf, pos: (bool(buf[pos]), pos + 1)
    if schema in ("int", "long"):
        return _read_long
    if schema == "float":
        return lambda buf, pos: (_F32.unpack_from(buf, pos)[0], pos + 4)
    if schema == "double":
        return lambda buf, pos: (_F64.unpack_from(buf, pos)[0], pos + 8)
    if schema == "string":
        def string(buf, pos):
            n, pos = _read_long(buf, pos)
            return str(buf[pos: pos + n], "utf-8"), pos + n
        return string
    if schema == "bytes":
        return _read_bytes
    raise NotImplementedError(f"avro type {schema!r}")


def _np_dtype(schema) -> Optional[np.dtype]:
    if isinstance(schema, dict):
        if schema["type"] == "enum":
            return None  # becomes a string column
        schema = schema["type"]
    if isinstance(schema, list):
        non_null = [s for s in schema if s != "null"]
        return _np_dtype(non_null[0]) if len(non_null) == 1 else None
    return {
        "boolean": np.dtype(bool), "int": np.dtype(np.int32),
        "long": np.dtype(np.int64), "float": np.dtype(np.float32),
        "double": np.dtype(np.float64),
    }.get(schema)


def read_avro(path, columns: Optional[List[str]] = None, device=None) -> Table:
    """Read an Avro container file into a Table (cudf.read_avro analog).
    ``path`` is anything ``Datasource.open`` takes (a path, bytes, an
    http(s) or s3 URL)."""
    from .datasource import Datasource

    dev = resolve_device(device)
    buf = memoryview(Datasource.open(path).read_all())
    assert bytes(buf[:4]) == _MAGIC, "not an Avro container file"
    pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        count, pos = _read_long(buf, pos)
        if count == 0:
            break
        if count < 0:  # block with byte size prefix
            _, pos = _read_long(buf, pos)
            count = -count
        for _ in range(count):
            k, pos = _read_bytes(buf, pos)
            v, pos = _read_bytes(buf, pos)
            meta[k.decode()] = v
    sync = bytes(buf[pos : pos + 16])
    pos += 16
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    assert schema.get("type") == "record", "top-level schema must be a record"
    fields = schema["fields"]

    rows: List[List[Any]] = [[] for _ in fields]
    steps = [(_decoder(fld["type"]), r.append) for fld, r in zip(fields, rows)]
    while pos < len(buf):
        count, pos = _read_long(buf, pos)
        nbytes, pos = _read_long(buf, pos)
        block = buf[pos : pos + nbytes]
        pos += nbytes
        assert bytes(buf[pos : pos + 16]) == sync, "sync marker mismatch"
        pos += 16
        if codec == "deflate":
            block = memoryview(zlib.decompress(bytes(block), -15))
        elif codec != "null":
            raise NotImplementedError(f"avro codec {codec}")
        bpos = 0
        for _ in range(count):
            for dec, append in steps:
                v, bpos = dec(block, bpos)
                append(v)

    cols = {}
    for fld, vals in zip(fields, rows):
        name = fld["name"]
        if columns is not None and name not in columns:
            continue
        dt = _np_dtype(fld["type"])
        present = np.fromiter((v is not None for v in vals), bool, len(vals))
        validity = None if present.all() else present
        if dt is not None:
            arr = (np.array(vals, dt) if validity is None
                   else np.array([0 if v is None else v for v in vals], dt))
        else:
            arr = np.array(["" if v is None else str(v) for v in vals], object)
        cols[name] = Column.from_numpy(arr, validity, device=dev)
    return Table(cols)


# -------------------------------------------------------------------- writer
def _write_long(v: int) -> bytes:
    z = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_varints(v: np.ndarray):
    """(bytes per value, flat bytes) of the zigzag varints of int64 ``v``:
    ``_write_long`` of every value at once."""
    z = ((v.astype(np.int64) << 1) ^ (v.astype(np.int64) >> 63)).view(np.uint64)
    nb = np.ones(len(z), np.int64)
    for j in range(1, 10):
        nb += (z >> np.uint64(7 * j)) != 0
    mat = np.empty((len(z), 10), np.uint8)
    for j in range(10):
        mat[:, j] = ((z >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8) \
            | np.where(j + 1 < nb, 0x80, 0).astype(np.uint8)
    return nb, mat[np.arange(10)[None, :] < nb[:, None]]


def _fixed(arr: np.ndarray):
    """(bytes per value, flat bytes) of fixed-width little-endian values."""
    raw = np.ascontiguousarray(arr).view(np.uint8)
    return np.full(len(arr), arr.dtype.itemsize, np.int64), raw


def _segments(lens: np.ndarray) -> np.ndarray:
    """Each byte's offset within its value, for values of ``lens`` bytes."""
    starts = np.cumsum(lens) - lens
    return np.arange(int(lens.sum())) - np.repeat(starts, lens)


def _column_bytes(col: Column, t: str, union: bool):
    """(bytes per row, flat bytes) of one column's Avro binary encoding in
    row order: a union's branch index first; zigzag varints for int and
    long; 1, 4 or 8 little-endian bytes for boolean, float and double; a
    string's varint length and UTF-8 bytes, encoded once per dictionary
    value. A float union's NaN is written as null, a temporal union's null
    as its NaT long (the reference's writer does both)."""
    n = col.length
    data = col.data[:n].cpu().numpy()
    null = np.zeros(n, bool) if col.validity is None else ~col.validity[:n].cpu().numpy()
    if union and col.dtype.is_floating:
        null |= np.isnan(data.astype(np.float64))
    if union and col.dtype.is_temporal:
        data = np.where(null, np.iinfo(np.int64).min, data)
        null = np.zeros(n, bool)  # a NaT is written as its long, as the reference does
    if t == "string":
        d = col.dictionary if col.dictionary is not None else np.array([], str)
        enc = [x.encode("utf-8") for x in np.asarray(d, dtype=str).tolist()] or [b""]
        lens_d, heads = _zigzag_varints(np.fromiter(map(len, enc), np.int64, len(enc)))
        pool = np.frombuffer(b"".join(enc), np.uint8)
        per = lens_d + np.fromiter(map(len, enc), np.int64, len(enc))
        codes = np.clip(data.astype(np.int64), 0, len(enc) - 1)
        blob = np.empty(int(per.sum()), np.uint8)
        at = np.cumsum(per) - per
        head_at = np.repeat(at, lens_d) + _segments(lens_d)
        blob[head_at] = heads
        tail_lens = per - lens_d
        blob[np.repeat(at + lens_d, tail_lens) + _segments(tail_lens)] = pool
        lens = per[codes]
        flat = blob[np.repeat(at[codes], lens) + _segments(lens)]
    elif t == "boolean":
        lens, flat = _fixed(data.astype(np.uint8))
    elif t == "float":
        lens, flat = _fixed(data.astype("<f4"))
    elif t == "double":
        lens, flat = _fixed(data.astype("<f8"))
    else:
        lens, flat = _zigzag_varints(data.view(np.int64) if data.dtype == np.uint64
                                     else data.astype(np.int64))
    if not union:
        return lens, flat
    keep = np.repeat(~null, lens)
    lens = np.where(null, 0, lens)
    flat = flat[keep]
    # a union's branch index first: 0 ("null") or 1, zigzagged
    out_lens = lens + 1
    out = np.empty(int(out_lens.sum()), np.uint8)
    starts = np.cumsum(out_lens) - out_lens
    out[starts] = np.where(null, 0, 2).astype(np.uint8)
    out[np.repeat(starts + 1, lens) + _segments(lens)] = flat
    return out_lens, out


def write_avro(tbl: Table, path: str, codec: str = "null") -> None:
    """Avro writer for primitives and nullable unions, one block (the
    ``IR.Sink("avro")`` format; libcudf ships only a reader). The body is
    encoded column by column with numpy and interleaved into records: the
    reference's bytes, which it writes value by value."""
    fields = []
    parts = []
    for name, col in tbl:
        if col.dtype.is_string:
            t = "string"
        elif col.dtype.kind == Kind.BOOL:
            t = "boolean"
        elif col.dtype.is_floating:
            t = "double" if col.dtype.bits > 32 else "float"
        else:
            t = "long" if col.dtype.bits > 32 else "int"
        union = col.validity is not None
        fields.append({"name": name, "type": ["null", t] if union else t})
        parts.append(_column_bytes(col, t, union))
    n = tbl.num_rows
    row_lens = sum((lens for lens, _ in parts), np.zeros(n, np.int64))
    out = np.empty(int(row_lens.sum()), np.uint8)
    at = np.cumsum(row_lens) - row_lens  # where each row's record starts
    for lens, flat in parts:
        out[np.repeat(at, lens) + _segments(lens)] = flat
        at = at + lens
    body = out.tobytes()
    schema = {"type": "record", "name": "row", "fields": fields}
    sync = b"\x13" * 16
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        body = comp.compress(body) + comp.flush()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        f.write(_write_long(len(meta)))
        for k, v in meta.items():
            kk = k.encode()
            f.write(_write_long(len(kk)) + kk)
            f.write(_write_long(len(v)) + v)
        f.write(_write_long(0))
        f.write(sync)
        if n:
            f.write(_write_long(n))
            f.write(_write_long(len(body)))
            f.write(body)
            f.write(sync)
