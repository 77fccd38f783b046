"""Fixed-point DECIMAL32/64 arithmetic with scale propagation.

Counterpart of ``cudf_tpu/ops/decimal.py`` (include/cudf/fixed_point/
fixed_point.hpp). A decimal column is an int64 (or int32) column whose
DType carries a power-of-ten ``scale``: value = unscaled * 10**scale
(scale <= 0 means digits after the point).

Scale rules (cudf::binary_operation on fixed_point):
  add/sub/mod : rescale both to min(scale_l, scale_r), scale_out = min
  mul         : scale_out = scale_l + scale_r (no rescale)
  div         : scale_out = scale_l - scale_r (truncates toward zero)
  compare     : rescale to min scale, compare unscaled

Rescaling to a smaller scale multiplies by 10^d and wraps on int64
overflow, as the reference does; to a larger scale it divides with
round-half-away-from-zero. A zero divisor (div, mod) gives a null with
data 0. torch's integer ``//`` and ``%`` floor, as jnp's do, so the
truncation is the reference's correction; the divisor is made safe
before dividing, because torch raises on an integer division by zero on
the CPU and returns garbage on CUDA.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import DType, Kind


def _scale(dt: DType) -> int:
    assert dt.kind == Kind.DECIMAL, dt
    return int(dt.param or 0)


def _dec(scale: int, bits: int) -> DType:
    return dtypes.decimal32(scale) if bits == 32 else dtypes.decimal64(scale)


def _to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f64 -> integer as XLA converts: NaN gives 0, out of range saturates
    (a plain torch cast leaves those undefined)."""
    info = torch.iinfo(dtype)
    x = torch.where(torch.isnan(x), 0.0, x)
    out = x.clamp(float(info.min), float(info.max)).to(dtype)
    # int64's max is not an f64: 2^63 would wrap to the minimum
    return torch.where(x >= float(info.max), info.max, out)


def from_integers(col: Column, scale: int = 0, bits: int = 64) -> Column:
    """Reinterpret an integer column as decimal with the given scale."""
    dt = _dec(scale, bits)
    return Column(dt, col.data.to(dt.physical), col.validity, col.length)


def from_floats(col: Column, scale: int, bits: int = 64) -> Column:
    """Quantize a float column to decimal (round half away from zero)."""
    dt = _dec(scale, bits)
    x = col.data.to(torch.float64) * (10.0 ** (-scale))
    unscaled = _to_int(torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)),
                       dt.physical)
    v = col.valid_mask()
    if col.dtype.is_floating:
        v = v & ~torch.isnan(col.data)
    return Column(dt, unscaled, v, col.length)


def to_floats(col: Column) -> Column:
    s = _scale(col.dtype)
    out = col.data.to(torch.float64) * (10.0 ** s)
    return Column(dtypes.float64, out, col.validity, col.length)


def _rescale_data(x: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    if to_scale == from_scale:
        return x
    if to_scale < from_scale:
        return x * (10 ** (from_scale - to_scale))
    f = 10 ** (to_scale - from_scale)
    # round half away from zero, like fixed_point::rescaled (floor division
    # alone would bias negatives downward)
    q = (torch.abs(x) + f // 2) // f
    return torch.where(x < 0, -q, q)


def rescale(col: Column, to_scale: int) -> Column:
    """fixed_point::rescaled: change scale, preserving value."""
    to_scale = int(to_scale)
    out = _rescale_data(col.data, _scale(col.dtype), to_scale)
    return Column(dtypes.decimal64(to_scale), out, col.validity, col.length)


_COMPARE = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
            "le": torch.le, "gt": torch.gt, "ge": torch.ge}


def _binop(lhs: Column, rhs: Column, op: str) -> Column:
    sl, sr = _scale(lhs.dtype), _scale(rhs.dtype)
    v = lhs.valid_mask() & rhs.valid_mask()
    n = lhs.length
    # arithmetic promotes to the 64-bit representation (decimal32 inputs
    # widen, as cudf's common type on fixed_point does)
    l, r = lhs.data.to(torch.int64), rhs.data.to(torch.int64)
    if op in ("add", "sub", "mod") or op in _COMPARE:
        s = min(sl, sr)
        l = _rescale_data(l, sl, s)
        r = _rescale_data(r, sr, s)
        if op == "add":
            return Column(dtypes.decimal64(s), l + r, v, n)
        if op == "sub":
            return Column(dtypes.decimal64(s), l - r, v, n)
        if op == "mod":
            safe = torch.where(r == 0, 1, r)
            out = torch.where(r == 0, 0, l - (l // safe) * safe)
            return Column(dtypes.decimal64(s), out, v & (r != 0), n)
        return Column(dtypes.bool_, _COMPARE[op](l, r), v, n)
    if op == "mul":
        return Column(dtypes.decimal64(sl + sr), l * r, v, n)
    if op == "div":
        safe = torch.where(r == 0, 1, r)
        q = l // safe
        # cudf fixed_point division truncates toward zero
        q = torch.where((l % safe != 0) & ((l < 0) != (r < 0)), q + 1, q)
        return Column(dtypes.decimal64(sl - sr), torch.where(r == 0, 0, q),
                      v & (r != 0), n)
    raise ValueError(f"decimal op {op!r}")


def binary_op(lhs: Column, rhs: Union[Column, int, float], op: str) -> Column:
    """Decimal binary op with cudf scale propagation. A Python int right
    operand is a decimal64 of scale 0, a float one is quantized to the left
    operand's scale."""
    if not isinstance(rhs, Column):
        if isinstance(rhs, int):
            rhs = Column(dtypes.decimal64(0), torch.full(lhs.data.shape, rhs, dtype=torch.int64,
                                                         device=lhs.device), None, lhs.length)
        else:
            rhs = from_floats(Column.from_scalar(float(rhs), lhs.length, device=lhs.device),
                              _scale(lhs.dtype))
    return _binop(lhs, rhs, op)


def round_decimal(col: Column, decimal_places: int = 0, how: str = "half_up") -> Column:
    """cudf::round on decimal columns (changes scale to -decimal_places)."""
    s = _scale(col.dtype)
    target = -int(decimal_places)
    if target <= s:
        return col
    f = 10 ** (target - s)
    x = col.data
    a = torch.abs(x)
    qa = a // f
    rem = a - qa * f
    if how == "half_up":
        up = 2 * rem >= f
    else:  # half_even
        up = (2 * rem > f) | ((2 * rem == f) & (qa % 2 != 0))
    qa = qa + up.to(qa.dtype)
    return Column(dtypes.decimal64(target), torch.where(x < 0, -qa, qa), col.validity,
                  col.length)


def format_unscaled(u: int, s: int) -> str:
    """The exact decimal spelling of ``u * 10**s``."""
    if s >= 0:
        return str(u * 10 ** s)
    d = 10 ** (-s)
    sign = "-" if u < 0 else ""
    u = abs(u)
    return f"{sign}{u // d}.{u % d:0{-s}d}"


def to_strings(col: Column) -> Column:
    """Host-format decimals as strings (strings/convert analog)."""
    s = _scale(col.dtype)
    vals = col.data[: col.length].cpu().numpy().tolist()
    v = None if col.validity is None else col.validity[: col.length].cpu().numpy()
    out = [None if v is not None and not v[i] else format_unscaled(u, s)
           for i, u in enumerate(vals)]
    return Column.from_numpy(np.array(out, object), device=col.device)
