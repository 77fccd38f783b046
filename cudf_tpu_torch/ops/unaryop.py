"""Unary ops, casts, null predicates, rounding, replace (counterpart of
``cudf_tpu/ops/unaryop.py``; libcudf's cpp/src/unary/, round/, replace/).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import DType

_UNARY = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "sqrt": torch.sqrt, "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "ceil": torch.ceil, "floor": torch.floor, "abs": torch.abs, "rint": torch.round,
    "neg": torch.neg, "bit_invert": torch.bitwise_not, "not": torch.logical_not,
}
_FLOAT_FNS = {"sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
              "tanh", "exp", "log", "log2", "log10", "sqrt", "cbrt"}


def unary_op(col: Column, op: str) -> Column:
    """Elementwise math op; the transcendental ones take integers to
    float64, ``not`` gives bool, the rest keep the dtype."""
    x = col.data
    out_dt = col.dtype
    if op == "not":
        out_dt = dtypes.bool_
    elif op in _FLOAT_FNS and not col.dtype.is_floating:
        out_dt = dtypes.float64
        x = x.to(torch.float64)
    elif op in ("ceil", "floor", "rint") and not col.dtype.is_floating:
        return Column(col.dtype, x, col.validity, col.length)
    out = _UNARY[op](x)
    return Column(out_dt, out.to(out_dt.physical), col.validity, col.length, None)


def cast(col: Column, to: DType) -> Column:
    if col.dtype == to:
        return col
    if col.dtype.is_string:
        # parse on the host, as the reference does
        vals = col.to_numpy()
        parsed = np.array([np.nan if v is None else v for v in vals])
        valid = None
        if col.validity is not None:
            valid = col.validity[: col.length].cpu().numpy()
        return Column.from_numpy(parsed.astype(dtypes.to_numpy(to)), validity=valid,
                                 device=col.device)
    if to.is_string:
        vals = col.to_numpy()
        strs = np.array([None if v is None or (isinstance(v, float) and np.isnan(v))
                         else str(v) for v in vals], dtype=object)
        return Column.from_numpy(strs, device=col.device)
    data = col.data
    if col.dtype.is_temporal and to.is_temporal:
        src_u, dst_u = col.dtype.param or "ns", to.param or "ns"
        factor = np.timedelta64(1, src_u) / np.timedelta64(1, dst_u)
        if factor >= 1:
            data = data * int(factor)
        else:
            data = torch.div(data, int(round(1 / factor)), rounding_mode="floor")
        return Column(to, data, col.validity, col.length)
    return Column(to, data.to(to.physical), col.validity, col.length, None)


def is_null(col: Column) -> Column:
    if col.validity is None:
        out = torch.zeros(col.capacity, dtype=torch.bool, device=col.device)
    else:
        out = ~col.validity & col.bounds_mask()
    return Column(dtypes.bool_, out, None, col.length)


def is_valid(col: Column) -> Column:
    if col.validity is None:
        out = torch.ones(col.capacity, dtype=torch.bool, device=col.device)
    else:
        out = col.validity
    return Column(dtypes.bool_, out, None, col.length)


def is_nan(col: Column) -> Column:
    if not col.dtype.is_floating:
        return Column(dtypes.bool_, torch.zeros(col.capacity, dtype=torch.bool,
                                                device=col.device), None, col.length)
    return Column(dtypes.bool_, torch.isnan(col.data), col.validity, col.length)


def nans_to_nulls(col: Column) -> Column:
    if not col.dtype.is_floating:
        return col
    nan = torch.isnan(col.data)
    v = ~nan if col.validity is None else col.validity & ~nan
    return Column(col.dtype, col.data, v, col.length)


def _as(value, col: Column) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of the column's physical type."""
    return torch.tensor(col.dtype.numpy_physical.type(value).item(), dtype=col.data.dtype,
                        device=col.device)


def replace_nulls(col: Column, value) -> Column:
    """cudf::replace_nulls with a scalar or column (cpp/src/replace/nulls.cu)."""
    from .strings import unify_dictionaries

    if col.validity is None:
        return col
    if isinstance(value, Column):
        if col.dtype.is_string:
            col, value = unify_dictionaries([col, value])
        data = torch.where(col.validity, col.data, value.data.to(col.data.dtype))
        validity = None if value.validity is None else col.validity | value.validity
        return Column(col.dtype, data, validity, col.length, col.dictionary)
    if col.dtype.is_string:
        # the value joins the dictionary (a host-side recode) and is coded
        col, _ = unify_dictionaries([col, Column.from_scalar(str(value), 1,
                                                             device=col.device)])
        code = int(np.searchsorted(col.dictionary, str(value)))
        data = torch.where(col.validity, col.data, code)
        return Column(col.dtype, data, None, col.length, col.dictionary)
    data = torch.where(col.validity, col.data, _as(value, col))
    return Column(col.dtype, data, None, col.length, col.dictionary)


def fill_nan(col: Column, value: float) -> Column:
    if not col.dtype.is_floating:
        return col
    data = torch.where(torch.isnan(col.data), _as(value, col), col.data)
    return Column(col.dtype, data, col.validity, col.length)


def clamp(col: Column, lo=None, hi=None) -> Column:
    data = col.data
    if lo is not None:
        data = torch.maximum(data, _as(lo, col))
    if hi is not None:
        data = torch.minimum(data, _as(hi, col))
    return Column(col.dtype, data, col.validity, col.length)


def round_col(col: Column, decimals: int = 0, how: str = "half_even") -> Column:
    """cudf::round (cpp/src/round/round.cu): HALF_EVEN and HALF_UP."""
    if col.dtype.is_integer and decimals >= 0:
        return col
    x = col.data if col.dtype.is_floating else col.data.to(torch.float64)
    scale = 10.0 ** decimals
    if how == "half_even":
        out = torch.round(x * scale) / scale
    else:  # half_up
        out = torch.sign(x) * torch.floor(torch.abs(x) * scale + 0.5) / scale
    return Column(col.dtype, out.to(col.dtype.physical), col.validity, col.length)


def find_and_replace(col: Column, to_replace, values) -> Column:
    """cudf::find_and_replace_all (cpp/src/replace/replace.cu): every
    value equal to ``to_replace[i]`` becomes ``values[i]``."""
    data = col.data
    out = data
    for old, new in zip(np.asarray(to_replace).tolist(), np.asarray(values).tolist()):
        out = torch.where(data == _as(old, col), _as(new, col), out)
    return Column(col.dtype, out, col.validity, col.length, col.dictionary)
