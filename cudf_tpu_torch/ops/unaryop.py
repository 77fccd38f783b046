"""Casts and null predicates (counterpart of part of ``cudf_tpu/ops/unaryop.py``).

Ported: ``cast``, ``is_null``, ``is_valid``, ``is_nan``, ``nans_to_nulls``.
The math ops, rounding and replace are a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import DType


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
