"""Binary operations with cuDF null semantics (counterpart of
``cudf_tpu/ops/binaryop.py``).

A scalar on either side broadcasts as a 0-d tensor: unlike the
reference, which first builds a full-length column from it, no buffer of
the column's length is made for a literal (``1 - l_discount`` at 60M rows
reads one column, not two). A string scalar compares against a string
column through the column's sorted dictionary (its insertion points), which
gives what comparing codes over the union dictionary gives. Operands
promote numpy-style (``/`` always yields a float); an output row is null
when either input row is null, except that ``and``/``or`` follow Kleene
logic (False & NULL = False, True | NULL = True).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column, scalar_dtype
from ..core.dtypes import DType, Kind
from .strings import unify_dictionaries
from .unaryop import cast

Scalar = Union[int, float, bool, str, np.generic, None]

_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}
_LOGICAL = {"and", "or"}
_FLOAT_OUT = {"atan2", "logb"}  # integer operands compute in float64
_APPLY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "floordiv": torch.floor_divide, "mod": torch.remainder, "pow": torch.pow,
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
    "and": torch.bitwise_and, "or": torch.bitwise_or, "xor": torch.bitwise_xor,
    "shift_left": torch.bitwise_left_shift, "shift_right": torch.bitwise_right_shift,
    "min": torch.minimum, "max": torch.maximum, "atan2": torch.atan2,
    "logb": lambda x, y: torch.log(x) / torch.log(y),
}
_FLIP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
_UNITS = ["Y", "M", "W", "D", "h", "m", "s", "ms", "us", "ns"]


class _Scalar:
    """A non-null scalar operand: its dtype and value."""

    __slots__ = ("dtype", "value")

    def __init__(self, dtype: DType, value):
        self.dtype = dtype
        self.value = value

    def tensor(self, dt: DType) -> torch.Tensor:
        """0-d CPU tensor of the value in ``dt``'s physical type (a CPU
        scalar tensor combines with tensors on any device)."""
        v = self.value
        if isinstance(v, (np.datetime64, np.timedelta64)):
            # the value in dt's unit: a duration stays a duration (its count
            # of days is not a count of dt's microseconds)
            kind = "m" if isinstance(v, np.timedelta64) else "M"
            v = v.astype(f"{kind}8[{dt.param or 'ns'}]").astype(np.int64)
        return torch.tensor(dt.numpy_physical.type(v).item(), dtype=dt.physical)


def _promote(ldt: DType, rdt: DType, op: str) -> DType:
    if op == "div":
        # true division yields float (pandas semantics); int/int -> float64
        if ldt.kind == Kind.FLOAT and rdt.kind == Kind.FLOAT:
            return dtypes.common_dtype(ldt, rdt)
        return dtypes.float64
    if ldt.is_temporal or rdt.is_temporal:
        return ldt if ldt.is_temporal else rdt
    return dtypes.common_dtype(ldt, rdt)


def _padded(t, cap: int, fill):
    if t is None or t.shape[0] == cap:
        return t
    out = torch.full((cap,), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def _string_scalar(col: Column, s: str, op: str) -> Column:
    """``col op s`` for a string column: codes against the insertion
    points of ``s`` in the column's sorted dictionary."""
    if op not in _CMP_OPS:
        raise TypeError(f"op {op} not supported on strings")
    d = col.dictionary if col.dictionary is not None else np.array([], dtype=str)
    lo = int(np.searchsorted(d, s, "left"))
    hi = int(np.searchsorted(d, s, "right"))
    codes = col.data
    if op in ("eq", "ne"):
        out = codes == lo if hi > lo else torch.zeros_like(codes, dtype=torch.bool)
        if op == "ne":
            out = ~out
    else:
        out = {"lt": codes < lo, "le": codes < hi,
               "gt": codes >= hi, "ge": codes >= lo}[op]
    return Column(dtypes.bool_, out, col.validity, col.length)


def _finer(a: DType, b: DType) -> str:
    return max(a.param or "ns", b.param or "ns", key=_UNITS.index)


def binary_op(lhs: Union[Column, Scalar], rhs: Union[Column, Scalar], op: str) -> Column:
    """Elementwise binary op between columns and/or scalars."""
    if op not in _APPLY:
        raise ValueError(f"unknown binary op {op!r}")
    if not isinstance(lhs, Column) and not isinstance(rhs, Column):
        raise TypeError("binary_op needs at least one Column")
    col = lhs if isinstance(lhs, Column) else rhs
    if lhs is None or rhs is None:  # a null scalar: an all-null column
        null = Column.from_scalar(None, col.length, col.dtype, device=col.device)
        lhs, rhs = (null, rhs) if lhs is None else (lhs, null)
    if isinstance(lhs, str) or isinstance(rhs, str):
        if not col.dtype.is_string:
            raise TypeError(f"cannot compare {col.dtype} with a string")
        return (_string_scalar(lhs, rhs, op) if isinstance(rhs, str)
                else _string_scalar(rhs, lhs, _FLIP.get(op, op)))
    if not isinstance(lhs, Column):
        lhs = _Scalar(scalar_dtype(lhs), lhs)
    if not isinstance(rhs, Column):
        rhs = _Scalar(scalar_dtype(rhs), rhs)
    both = isinstance(lhs, Column) and isinstance(rhs, Column)
    if both and lhs.length != rhs.length:
        raise ValueError(f"operand lengths differ: {lhs.length} vs {rhs.length}")
    if lhs.dtype.is_string or rhs.dtype.is_string:
        if op not in _CMP_OPS or not both:
            raise TypeError(f"op {op} not supported on strings")
        lhs, rhs = unify_dictionaries([lhs, rhs])
    if lhs.dtype.is_temporal and rhs.dtype.is_temporal \
            and lhs.dtype.param != rhs.dtype.param:
        # normalize to the finer unit before comparing or subtracting
        unit = _finer(lhs.dtype, rhs.dtype)
        lhs, rhs = [
            cast(x, DType(x.dtype.kind, 64, unit)) if isinstance(x, Column)
            else _Scalar(DType(x.dtype.kind, 64, unit), x.value) for x in (lhs, rhs)]

    ldt, rdt = lhs.dtype, rhs.dtype
    if ldt.is_string:
        out_dt, common = dtypes.bool_, ldt
    elif op in _CMP_OPS:
        common = ldt if ldt.is_temporal else dtypes.common_dtype(ldt, rdt)
        out_dt = dtypes.bool_
    elif op in _LOGICAL and ldt.kind == Kind.BOOL:
        out_dt = common = dtypes.bool_
    else:
        out_dt = _promote(ldt, rdt, op)
        if ldt.is_temporal and rdt.is_temporal and op == "sub":
            out_dt = dtypes.duration(ldt.param)
        if op in _FLOAT_OUT and not out_dt.is_floating:
            out_dt = dtypes.float64
        common = out_dt

    cap = max(x.capacity for x in (lhs, rhs) if isinstance(x, Column))

    def operand(x):
        if isinstance(x, _Scalar):
            return x.tensor(common)
        return _padded(x.data, cap, 0).to(common.physical)

    x, y = operand(lhs), operand(rhs)
    out = _APPLY[op](x, y)
    if out.dtype != out_dt.physical:
        out = out.to(out_dt.physical)

    lv = _padded(lhs.validity, cap, False) if isinstance(lhs, Column) else None
    rv = _padded(rhs.validity, cap, False) if isinstance(rhs, Column) else None
    if op in _LOGICAL and (lv is not None or rv is not None):
        ones = torch.ones(cap, dtype=torch.bool, device=out.device)
        lvv = ones if lv is None else lv
        rvv = ones if rv is None else rv
        lb, rb = x.to(torch.bool), y.to(torch.bool)
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
    return Column(out_dt, out, validity, col.length)


# convenience wrappers -------------------------------------------------------
def add(l, r):
    return binary_op(l, r, "add")


def sub(l, r):
    return binary_op(l, r, "sub")


def mul(l, r):
    return binary_op(l, r, "mul")


def div(l, r):
    return binary_op(l, r, "div")


def eq(l, r):
    return binary_op(l, r, "eq")
