"""Binary operations with cuDF null semantics (counterpart of
``cudf_tpu/ops/binaryop.py``: comparisons, ``+ - * /`` and Kleene
``and``/``or``; the rest of the reference's op zoo is a later slice).

A scalar on either side broadcasts to the column's length; operands
promote numpy-style (``/`` always yields a float); an output row is null
when either input row is null, except that ``and``/``or`` follow Kleene
logic (False & NULL = False, True | NULL = True).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import Kind
from .strings import unify_dictionaries
from .unaryop import cast

Scalar = Union[int, float, bool, str, np.generic, None]

_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}
_LOGICAL = {"and", "or"}
_APPLY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
    "and": torch.bitwise_and, "or": torch.bitwise_or,
}
_UNITS = ["Y", "M", "W", "D", "h", "m", "s", "ms", "us", "ns"]


def _broadcast_scalar(value: Scalar, like: Column) -> Column:
    if isinstance(value, Column):
        return value
    if isinstance(value, np.datetime64):
        return Column.from_numpy(np.full(like.length, value), device=like.device)
    return Column.from_scalar(value, like.length, like.dtype if value is None else None,
                              device=like.device)


def _promote(lhs: Column, rhs: Column, op: str) -> dtypes.DType:
    if op == "div":
        # true division yields float (pandas semantics); int/int -> float64
        if lhs.dtype.kind == Kind.FLOAT and rhs.dtype.kind == Kind.FLOAT:
            return dtypes.common_dtype(lhs.dtype, rhs.dtype)
        return dtypes.float64
    if lhs.dtype.is_temporal or rhs.dtype.is_temporal:
        return lhs.dtype if lhs.dtype.is_temporal else rhs.dtype
    return dtypes.common_dtype(lhs.dtype, rhs.dtype)


def _padded(t, cap: int, fill):
    if t is None or t.shape[0] == cap:
        return t
    out = torch.full((cap,), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def binary_op(lhs: Union[Column, Scalar], rhs: Union[Column, Scalar], op: str) -> Column:
    """Elementwise binary op between columns and/or scalars."""
    if op not in _APPLY:
        raise ValueError(f"unknown binary op {op!r}")
    if not isinstance(lhs, Column):
        if not isinstance(rhs, Column):
            raise TypeError("binary_op needs at least one Column")
        lhs = _broadcast_scalar(lhs, rhs)
    if not isinstance(rhs, Column):
        rhs = _broadcast_scalar(rhs, lhs)
    if lhs.length != rhs.length:
        raise ValueError(f"operand lengths differ: {lhs.length} vs {rhs.length}")
    if lhs.dtype.is_string or rhs.dtype.is_string:
        if op not in _CMP_OPS:
            raise TypeError(f"op {op} not supported on strings")
        lhs, rhs = unify_dictionaries([lhs, rhs])
    if lhs.dtype.is_temporal and rhs.dtype.is_temporal \
            and lhs.dtype.param != rhs.dtype.param:
        # normalize to the finer unit before comparing or subtracting
        finer = max(lhs.dtype.param or "ns", rhs.dtype.param or "ns", key=_UNITS.index)
        lhs = cast(lhs, dtypes.DType(lhs.dtype.kind, 64, finer))
        rhs = cast(rhs, dtypes.DType(rhs.dtype.kind, 64, finer))

    cap = max(lhs.capacity, rhs.capacity)
    ldata, rdata = _padded(lhs.data, cap, 0), _padded(rhs.data, cap, 0)
    if lhs.dtype.is_string:
        out_dt, x, y = dtypes.bool_, ldata, rdata
    elif op in _CMP_OPS:
        common = lhs.dtype if lhs.dtype.is_temporal else \
            dtypes.common_dtype(lhs.dtype, rhs.dtype)
        x, y = ldata.to(common.physical), rdata.to(common.physical)
        out_dt = dtypes.bool_
    elif op in _LOGICAL and lhs.dtype.kind == Kind.BOOL:
        out_dt, x, y = dtypes.bool_, ldata, rdata
    else:
        out_dt = _promote(lhs, rhs, op)
        if lhs.dtype.is_temporal and rhs.dtype.is_temporal and op == "sub":
            out_dt = dtypes.duration(lhs.dtype.param)
        x, y = ldata.to(out_dt.physical), rdata.to(out_dt.physical)
    out = _APPLY[op](x, y)
    if out.dtype != out_dt.physical:
        out = out.to(out_dt.physical)

    lv, rv = _padded(lhs.validity, cap, False), _padded(rhs.validity, cap, False)
    if op in _LOGICAL and (lv is not None or rv is not None):
        ones = torch.ones(cap, dtype=torch.bool, device=out.device)
        lvv = ones if lv is None else lv
        rvv = ones if rv is None else rv
        lb, rb = ldata.to(torch.bool), rdata.to(torch.bool)
        if op == "and":
            validity = (lvv & rvv) | (lvv & ~lb) | (rvv & ~rb)
        else:
            validity = (lvv & rvv) | (lvv & lb) | (rvv & rb)
        out = torch.where(validity, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
    elif lv is None:
        validity = rv
    elif rv is None:
        validity = lv
    else:
        validity = lv & rv
    return Column(out_dt, out, validity, lhs.length)
