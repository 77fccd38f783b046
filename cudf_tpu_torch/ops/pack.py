"""pack / unpack / contiguous_split: one-blob table serialization
(counterpart of ``cudf_tpu/ops/pack.py``).

Analog of include/cudf/contiguous_split.hpp:93-146 (pack, chunked_pack,
unpack; the wire format ``packed_columns{host metadata, one contiguous
buffer}``). The blob is host bytes, 64-byte-aligned sections and a JSON
header, byte for byte the reference's for the same table, so either
package unpacks the other's blobs: a column's logical rows in their
physical little-endian layout, its validity as an Arrow bitmap (least
significant bit first), and a string column's dictionary in the header.
``pack`` copies each column to the host once; ``unpack`` uploads each
column once, to ``device``.

Not copied from the reference: its ``unpack`` rebuilds a categorical as a
string column and re-encodes a string column's dictionary; here a string
column keeps its dictionary and codes, and a categorical its categories
(as the strings the header holds), its codes and its order flag.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

from ..core.column import Column, _pad_to, resolve_device
from ..core.dtypes import DType, Kind
from ..core.table import Table
from ..utils.padding import bucket_capacity

_ALIGN = 64
_MAGIC = "cudf_tpu.packed.v1"


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


@dataclass
class PackedColumns:
    """Host metadata + one contiguous buffer (packed_columns analog)."""

    metadata: bytes
    buffer: bytes

    @property
    def nbytes(self) -> int:
        return len(self.metadata) + len(self.buffer)


def _column_sections(col: Column):
    """(name, host array) sections of one column's logical rows."""
    n = col.length
    if col.dtype.kind == Kind.FLOAT and col.dtype.bits == 16:
        data = col.data[:n].to(torch.float32).cpu().numpy()
    else:
        data = col.data[:n].cpu().numpy()
    secs = [("data", data)]
    if col.validity is not None:
        secs.append(("validity", np.packbits(col.validity[:n].cpu().numpy(),
                                             bitorder="little")))
    return secs


def pack(tbl: Table) -> PackedColumns:
    """Serialize a table into one contiguous aligned blob."""
    header = {"magic": _MAGIC, "num_rows": tbl.num_rows, "columns": []}
    chunks: List[bytes] = []
    off = 0
    for name, col in tbl:
        centry = {"name": name, "dtype": col.dtype.kind, "bits": col.dtype.bits,
                  "param": col.dtype.param, "sections": {}}
        if col.dictionary is not None:
            centry["dictionary"] = [str(x) for x in col.dictionary]
        for sname, arr in _column_sections(col):
            raw = np.ascontiguousarray(arr).tobytes()
            centry["sections"][sname] = {"offset": off, "nbytes": len(raw),
                                         "np_dtype": arr.dtype.str}
            chunks.append(raw)
            pad = _aligned(len(raw)) - len(raw)
            if pad:
                chunks.append(b"\0" * pad)
            off += _aligned(len(raw))
        header["columns"].append(centry)
    return PackedColumns(json.dumps(header).encode(), b"".join(chunks))


def _dtype_of(centry) -> DType:
    kind, param = centry["dtype"], centry["param"]
    if kind == Kind.DICTIONARY and param is not None:
        return DType(kind, centry["bits"], tuple(param))
    if kind in (Kind.TIMESTAMP, Kind.DURATION):
        return DType(kind, 64, param or "ns")
    if kind == Kind.DECIMAL:
        return DType(kind, 64, param or 0)
    return DType(kind, centry["bits"], param)


def unpack(packed: PackedColumns, device=None) -> Table:
    """Rebuild a Table from a packed blob: each column is uploaded once."""
    dev = resolve_device(device)
    header = json.loads(packed.metadata.decode())
    if header["magic"] != _MAGIC:
        raise ValueError("not a cudf_tpu packed blob")
    n = header["num_rows"]
    cap = bucket_capacity(n)
    buf = memoryview(packed.buffer)
    cols = {}
    for centry in header["columns"]:
        dsec = centry["sections"]["data"]
        data = np.frombuffer(buf[dsec["offset"]: dsec["offset"] + dsec["nbytes"]],
                             dtype=np.dtype(dsec["np_dtype"]))
        dt = _dtype_of(centry)
        validity = None
        if "validity" in centry["sections"]:
            vsec = centry["sections"]["validity"]
            bits = np.frombuffer(buf[vsec["offset"]: vsec["offset"] + vsec["nbytes"]],
                                 np.uint8)
            validity = _pad_to(np.unpackbits(bits, bitorder="little")[:n].astype(bool),
                               cap, dev, False)
        dictionary = None
        if "dictionary" in centry:
            dictionary = np.asarray(centry["dictionary"], str if dt.is_string else object)
        if dt.kind == Kind.FLOAT and dt.bits == 16:
            d = _pad_to(data, cap, dev).to(torch.bfloat16)
        else:
            d = _pad_to(data.astype(dt.numpy_physical, copy=False), cap, dev)
        cols[centry["name"]] = Column(dt, d, validity, n, dictionary)
    return Table(cols)


def contiguous_split(tbl: Table, splits: List[int]) -> List[PackedColumns]:
    """cudf::contiguous_split: slice at row offsets, pack each piece."""
    bounds = [0] + list(splits) + [tbl.num_rows]
    return [pack(tbl.slice(s, e - s)) for s, e in zip(bounds[:-1], bounds[1:])]


def chunked_pack(tbl: Table, chunk_rows: int) -> Iterator[PackedColumns]:
    """cudf::chunked_pack: bounded-memory streaming serialization."""
    if tbl.num_rows == 0:
        yield pack(tbl)
        return
    for s in range(0, tbl.num_rows, chunk_rows):
        yield pack(tbl.slice(s, min(chunk_rows, tbl.num_rows - s)))
