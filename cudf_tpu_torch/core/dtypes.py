"""Logical dtype system for cudf_tpu_torch.

Counterpart of ``cudf_tpu/core/dtypes.py``: every logical dtype maps onto
one *physical* torch dtype stored in device memory, and logical semantics
(timestamps, durations, decimals, dictionary codes) stay metadata.
``numpy_physical`` is the host-side twin used at ingest and export.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


class Kind:
    """Logical type kinds (analog of cudf::type_id families)."""

    BOOL = "bool"
    INT = "int"
    UINT = "uint"
    FLOAT = "float"
    TIMESTAMP = "timestamp"  # int64 physical, unit metadata
    DURATION = "duration"    # int64 physical, unit metadata
    DECIMAL = "decimal"      # int64 physical, scale metadata (DECIMAL64 analog)
    STRING = "string"        # dictionary-encoded int32 codes + host values
    DICTIONARY = "dictionary"
    LIST = "list"            # offsets + child (core/lists.py), param: the child's dtype
    STRUCT = "struct"        # named children (core/structs.py)


_INT = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}
_UINT = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32, 64: torch.uint64}
_FLOAT = {16: torch.bfloat16, 32: torch.float32, 64: torch.float64}


@dataclasses.dataclass(frozen=True)
class DType:
    """A logical dtype; ``param`` carries a unit (temporal) or scale (decimal)."""

    kind: str
    bits: int
    param: Any = None

    @property
    def physical(self) -> torch.dtype:
        if self.kind == Kind.BOOL:
            return torch.bool
        if self.kind == Kind.INT:
            return _INT[self.bits]
        if self.kind == Kind.UINT:
            return _UINT[self.bits]
        if self.kind == Kind.FLOAT:
            return _FLOAT[self.bits]
        if self.kind == Kind.DECIMAL:
            return torch.int32 if self.bits == 32 else torch.int64
        if self.kind in (Kind.TIMESTAMP, Kind.DURATION):
            return torch.int64
        if self.kind in (Kind.STRING, Kind.DICTIONARY):
            return torch.int32  # dictionary codes
        raise TypeError(f"no physical dtype for {self}")

    @property
    def numpy_physical(self) -> np.dtype:
        if self.kind == Kind.FLOAT and self.bits == 16:
            raise TypeError("numpy has no bfloat16")
        return np.dtype(str(self.physical).replace("torch.", ""))

    @property
    def is_numeric(self) -> bool:
        return self.kind in (Kind.INT, Kind.UINT, Kind.FLOAT, Kind.BOOL, Kind.DECIMAL)

    @property
    def is_floating(self) -> bool:
        return self.kind == Kind.FLOAT

    @property
    def is_integer(self) -> bool:
        return self.kind in (Kind.INT, Kind.UINT)

    @property
    def is_temporal(self) -> bool:
        return self.kind in (Kind.TIMESTAMP, Kind.DURATION)

    @property
    def is_string(self) -> bool:
        return self.kind == Kind.STRING

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        p = f"[{self.param}]" if self.param is not None else ""
        return f"{self.kind}{self.bits}{p}"


bool_ = DType(Kind.BOOL, 8)
int8 = DType(Kind.INT, 8)
int16 = DType(Kind.INT, 16)
int32 = DType(Kind.INT, 32)
int64 = DType(Kind.INT, 64)
uint8 = DType(Kind.UINT, 8)
uint16 = DType(Kind.UINT, 16)
uint32 = DType(Kind.UINT, 32)
uint64 = DType(Kind.UINT, 64)
bfloat16 = DType(Kind.FLOAT, 16)
float32 = DType(Kind.FLOAT, 32)
float64 = DType(Kind.FLOAT, 64)
string = DType(Kind.STRING, 32)


def timestamp(unit: str = "ns") -> DType:
    return DType(Kind.TIMESTAMP, 64, unit)


def duration(unit: str = "ns") -> DType:
    return DType(Kind.DURATION, 64, unit)


def decimal64(scale: int = 0) -> DType:
    """fixed_point decimal64 (int64 unscaled + power-of-ten scale)."""
    return DType(Kind.DECIMAL, 64, scale)


def decimal32(scale: int = 0) -> DType:
    """fixed_point decimal32 (int32 unscaled + power-of-ten scale)."""
    return DType(Kind.DECIMAL, 32, scale)


_NP_MAP = {
    np.dtype("bool"): bool_,
    np.dtype("int8"): int8,
    np.dtype("int16"): int16,
    np.dtype("int32"): int32,
    np.dtype("int64"): int64,
    np.dtype("uint8"): uint8,
    np.dtype("uint16"): uint16,
    np.dtype("uint32"): uint32,
    np.dtype("uint64"): uint64,
    np.dtype("float32"): float32,
    np.dtype("float64"): float64,
}


def from_numpy(np_dtype) -> DType:
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind == "M":
        return timestamp(np.datetime_data(np_dtype)[0])
    if np_dtype.kind == "m":
        return duration(np.datetime_data(np_dtype)[0])
    if np_dtype.kind in ("U", "O", "S"):
        return string
    try:
        return _NP_MAP[np_dtype]
    except KeyError:
        raise TypeError(f"unsupported numpy dtype {np_dtype}") from None


def from_name(name: str) -> DType:
    """DType from its host-buffer name: ``"string"`` or a numpy dtype name
    (``"int32"``, ``"float64"``, ``"datetime64[ns]"``...)."""
    if name == "string":
        return string
    return from_numpy(np.dtype(name))


def to_numpy(dt: DType) -> np.dtype:
    if dt.kind == Kind.TIMESTAMP:
        return np.dtype(f"datetime64[{dt.param or 'ns'}]")
    if dt.kind == Kind.DURATION:
        return np.dtype(f"timedelta64[{dt.param or 'ns'}]")
    if dt.kind in (Kind.STRING, Kind.LIST):
        return np.dtype(object)
    if dt.kind == Kind.FLOAT and dt.bits == 16:
        return np.dtype("float32")  # numpy lacks bfloat16; widen
    return dt.numpy_physical


def common_dtype(a: DType, b: DType) -> DType:
    """Numpy-style promotion between two logical dtypes."""
    if a == b:
        return a
    if a.is_temporal or b.is_temporal:
        if a.kind == b.kind:
            if a.param == b.param:
                return a
            return timestamp("ns") if a.kind == Kind.TIMESTAMP else duration("ns")
        # timestamp - timestamp is handled at the op level
        return a if a.is_temporal else b
    return from_numpy(np.promote_types(to_numpy(a), to_numpy(b)))
