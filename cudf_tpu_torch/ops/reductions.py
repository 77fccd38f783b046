"""Full-column reductions and scans (counterpart of
``cudf_tpu/ops/reductions.py``; libcudf's cpp/src/reductions/).

Each reduction is one masked torch reduction, and its result a 1-row
column, as in the reference. Nulls are skipped; an empty or all-null input
gives null. The order statistics (median, quantile, nunique, first, last)
go through a one-group ``groupby_aggregate``, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import DType
from .sortprim import tiled_cummax, tiled_cummin, tiled_cumprod, tiled_cumsum

_ACC_DTYPE = {torch.float32: dtypes.float32, torch.float64: dtypes.float64,
              torch.int64: dtypes.int64}


def _acc(dt: DType) -> torch.dtype:
    if dt.is_floating:
        return torch.float32 if dt.bits <= 32 else torch.float64
    return torch.int64


def _ident(dt: torch.dtype, for_min: bool):
    if dt.is_floating_point:
        return math.inf if for_min else -math.inf
    info = torch.iinfo(dt)
    return info.max if for_min else info.min


def _row(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1)


def _reduce_impl(col: Column, kind: str, param) -> Column:
    valid = col.valid_mask()
    cnt = valid.sum()
    nonempty = _row(cnt > 0)
    x = col.data

    if kind == "count":
        return Column(dtypes.int64, _row(cnt), None, 1)
    if kind == "size":
        return Column(dtypes.int64, torch.full((1,), col.length, dtype=torch.int64,
                                               device=x.device), None, 1)

    if kind in ("sum", "mean", "var", "std", "sum_of_squares", "m2"):
        acc = _acc(col.dtype)
        xz = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device)).to(acc)
        s = xz.sum()
        if kind == "sum":
            return Column(_ACC_DTYPE[acc], _row(s), nonempty, 1)
        if kind == "sum_of_squares":
            return Column(_ACC_DTYPE[acc], _row((xz * xz).sum()), nonempty, 1)
        mean = s.to(torch.float64) / cnt.clamp(min=1)
        if kind == "mean":
            return Column(dtypes.float64, _row(mean), nonempty, 1)
        cent = torch.where(valid, x.to(torch.float64) - mean, 0.0)
        m2 = (cent * cent).sum()
        if kind == "m2":
            return Column(dtypes.float64, _row(m2), nonempty, 1)
        ddof = int(param) if param else 1
        denom = cnt - ddof
        ok = denom > 0
        var = torch.where(ok, m2 / denom.clamp(min=1), math.nan)
        out = var if kind == "var" else torch.sqrt(var)
        return Column(dtypes.float64, _row(out), nonempty & _row(ok), 1)

    if kind in ("min", "max", "argmin", "argmax"):
        for_min = kind in ("min", "argmin")
        xm = torch.where(valid, x, torch.full((), _ident(x.dtype, for_min), dtype=x.dtype,
                                             device=x.device))
        if kind in ("min", "max"):
            r = xm.min() if for_min else xm.max()
            return Column(col.dtype, _row(r), nonempty, 1, col.dictionary)
        r = xm.argmin() if for_min else xm.argmax()
        return Column(dtypes.int64, _row(r.to(torch.int64)), nonempty, 1)

    if kind == "product":
        acc = _acc(col.dtype)
        xz = torch.where(valid, x, torch.ones((), dtype=x.dtype, device=x.device)).to(acc)
        return Column(_ACC_DTYPE[acc], _row(xz.prod()), nonempty, 1)

    if kind in ("any", "all"):
        b = x.to(torch.bool)
        r = (valid & b).any() if kind == "any" else (~valid | b).all()
        return Column(dtypes.bool_, _row(r), None, 1)

    raise ValueError(f"unsupported reduction {kind!r}")


def reduce(col: Column, kind: str, param=0.0) -> Column:
    """Reduce a column to a 1-row column (null if empty/all-null)."""
    if kind in ("median", "quantile", "nunique", "first", "last"):
        return _order_reduce(col, kind, param)
    return _reduce_impl(col, kind, float(param) if param else 0.0)


def _order_reduce(col: Column, kind: str, param) -> Column:
    from ..core.table import Table
    from .groupby import AggSpec, groupby_aggregate

    key = Column(dtypes.int8, torch.zeros(col.capacity, dtype=torch.int8,
                                          device=col.device), None, col.length)
    t = Table({"__k": key, "v": col})
    out = groupby_aggregate(t, ["__k"], [AggSpec("v", kind, "r",
                                                 float(param) if param else 0.0)])
    return out["r"]


def to_scalar(col: Column):
    """1-row column -> python scalar (None if null)."""
    v = col.to_numpy()
    if len(v) == 0:
        return None
    x = v[0]
    if x is None or (isinstance(x, float) and np.isnan(x) and col.null_count):
        return None
    return x.item() if hasattr(x, "item") else x


_SCAN_KINDS = ("cumsum", "cummax", "cummin", "cumprod", "cumcount")


def scan(col: Column, kind: str) -> Column:
    """Inclusive scan over the rows; a null row adds the identity and
    stays null."""
    valid = col.valid_mask()
    x = col.data
    if kind in ("cumsum", "cumprod"):
        fill = torch.zeros if kind == "cumsum" else torch.ones
        xz = torch.where(valid, x, fill((), dtype=x.dtype, device=x.device))
        out = tiled_cumsum(xz) if kind == "cumsum" else tiled_cumprod(xz)
        out_dt = col.dtype if col.dtype.is_floating else dtypes.int64
        out = out.to(out_dt.physical)
    elif kind in ("cummax", "cummin"):
        ident = _ident(x.dtype, kind == "cummin")
        xz = torch.where(valid, x, torch.full((), ident, dtype=x.dtype, device=x.device))
        out = tiled_cummin(xz) if kind == "cummin" else tiled_cummax(xz)
        out_dt = col.dtype
    elif kind == "cumcount":
        out = tiled_cumsum(valid.to(torch.int64))
        out_dt = dtypes.int64
    else:
        raise ValueError(kind)
    return Column(out_dt, out, col.validity, col.length, col.dictionary)


def _linear_scan(a: torch.Tensor, bs):
    """Inclusive scan of the recurrences y_i = a_i·y_{i-1} + b_i (one per
    tensor in ``bs``, one shared ``a``): log2(n) doubling steps composing
    (a, b) pairs as the reference's associative scan does."""
    n = a.shape[0]
    d = 1
    while d < n:
        bs = [torch.cat([b[:d], a[d:] * b[:-d] + b[d:]]) for b in bs]
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return bs


def ewma(col: Column, alpha: float, adjust: bool = True) -> Column:
    """Exponentially weighted moving average (the EWMA aggregation of
    include/cudf/aggregation.hpp) over valid, non-NaN rows."""
    x = col.data.to(torch.float64)
    valid = col.valid_mask()
    if col.dtype.is_floating:
        valid = valid & ~torch.isnan(col.data)
    a = float(alpha)
    if adjust:
        # y_i = sum_j w^(i-j) x_j / sum_j w^(i-j), w = 1-a, over valid rows
        A = 1.0 - a * valid.to(torch.float64)
        num, den = _linear_scan(A, [torch.where(valid, x, 0.0),
                                    valid.to(torch.float64)])
        out = num / den.clamp(min=1e-300)
    else:
        # y_first = x_first; y_i = (1-a) y_{i-1} + a x_i; invalid rows carry
        first = valid & (torch.cumsum(valid.to(torch.int32), 0) == 1)
        A = (1.0 - a * valid.to(torch.float64)) * (~first).to(torch.float64)
        B = torch.where(first, x, torch.where(valid, a * x, 0.0))
        (out,) = _linear_scan(A, [B])
    validity = (torch.cumsum(valid.to(torch.int32), 0) > 0) & col.bounds_mask()
    return Column(dtypes.float64, out, validity, col.length)
