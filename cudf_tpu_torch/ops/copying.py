"""Gather and concatenate over padded columns (counterpart of
``cudf_tpu/ops/copying.py``)."""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.column import Column
from ..core.table import Table
from ..utils.padding import bucket_capacity


def _gather_kernel(col: Column, idx: torch.Tensor, check_bounds: bool):
    safe = idx.clamp(0, col.capacity - 1)
    out = col.data[safe]
    if col.validity is None and not check_bounds:
        return out, None
    in_bounds = (idx >= 0) & (idx < col.length)
    if col.validity is not None:
        return out, col.validity[safe] & in_bounds
    return out, in_bounds


def gather(col: Column, indices: torch.Tensor, out_length: int,
           check_bounds: bool = False) -> Column:
    """col.data[indices] with null propagation.

    ``indices`` has shape (out_capacity,); entries beyond ``out_length`` are
    ignored. Negative / out-of-range indices yield null when the column has
    validity or ``check_bounds`` is set (cuDF's out_of_bounds_policy::NULLIFY).
    """
    out, v = _gather_kernel(col, indices.to(torch.int64), check_bounds)
    return Column(col.dtype, out, v, out_length, col.dictionary)


def gather_table(tbl: Table, indices: torch.Tensor, out_length: int,
                 check_bounds: bool = False) -> Table:
    idx = indices.to(torch.int64)
    return Table({n: gather(c, idx, out_length, check_bounds) for n, c in tbl})


def concatenate(cols: Sequence[Column]) -> Column:
    """Concatenate columns of one logical dtype (string columns are first
    recoded onto their union dictionary)."""
    from .strings import unify_dictionaries

    if not cols:
        raise ValueError("empty concatenate")
    dt = cols[0].dtype
    if any(c.dtype != dt for c in cols):
        raise TypeError(f"concatenate needs one dtype, got {[c.dtype for c in cols]}")
    if dt.is_string:
        cols = unify_dictionaries(list(cols))
    total = sum(c.length for c in cols)
    cap = bucket_capacity(total)
    dev = cols[0].device
    data = torch.zeros(cap, dtype=cols[0].data.dtype, device=dev)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.zeros(cap, dtype=torch.bool, device=dev)
    at = 0
    for c in cols:
        n = c.length
        data[at:at + n] = c.data[:n]
        if validity is not None:
            validity[at:at + n] = True if c.validity is None else c.validity[:n]
        at += n
    return Column(dt, data, validity, total, cols[0].dictionary)


def concatenate_tables(tables: Sequence[Table]) -> Table:
    names = tables[0].names
    return Table({n: concatenate([t[n] for t in tables]) for n in names})


def copy_if_else(lhs: Column, rhs, cond: Column) -> Column:
    """cudf::copy_if_else (cpp/src/copying/copy.cu): lhs where cond else
    rhs; a null condition takes rhs. ``rhs`` may be a Column or a scalar;
    a None scalar, or a NaN one against a non-float column, gives nulls.
    The output has lhs's dtype."""
    import numpy as np

    from .strings import unify_dictionaries

    c = cond.data.to(torch.bool)
    if cond.validity is not None:
        c = c & cond.validity
    null_rhs = rhs is None or (isinstance(rhs, float) and np.isnan(rhs)
                               and not lhs.dtype.is_floating)
    if isinstance(rhs, Column):
        if lhs.dtype.is_string:
            lhs, rhs = unify_dictionaries([lhs, rhs])
        rdata, rv = rhs.data.to(lhs.data.dtype), rhs.validity
    elif null_rhs:
        rdata = torch.zeros((), dtype=lhs.data.dtype, device=lhs.device)
        rv = torch.zeros(lhs.capacity, dtype=torch.bool, device=lhs.device)
    else:
        if lhs.dtype.is_string:
            lhs, _ = unify_dictionaries([lhs, Column.from_scalar(str(rhs), 1,
                                                                    device=lhs.device)])
            rhs = int(np.searchsorted(lhs.dictionary, str(rhs)))
        rdata = torch.tensor(lhs.dtype.numpy_physical.type(rhs).item(),
                             dtype=lhs.data.dtype, device=lhs.device)
        rv = None
    data = torch.where(c, lhs.data, rdata)
    validity = None
    if lhs.validity is not None or rv is not None:
        ones = torch.ones(c.shape, dtype=torch.bool, device=c.device)
        validity = torch.where(c, ones if lhs.validity is None else lhs.validity,
                               ones if rv is None else rv)
    return Column(lhs.dtype, data, validity, lhs.length, lhs.dictionary)


def interleave_columns(tbl: Table) -> Column:
    """cudf::interleave_columns (cpp/src/reshape/interleave_columns.cu):
    columns [a b c] of n rows become one column [a0 b0 c0 a1 b1 c1 ...]
    in the first column's dtype (string columns on their union
    dictionary)."""
    from .strings import unify_dictionaries

    cols = [c for _, c in tbl]
    if cols[0].dtype.is_string:
        cols = unify_dictionaries(cols)
    n, k = cols[0].length, len(cols)
    total = n * k
    cap = bucket_capacity(total)
    dev = cols[0].device
    data = torch.zeros(cap, dtype=cols[0].data.dtype, device=dev)
    data[:total] = torch.stack([c.data[:n].to(data.dtype) for c in cols], 1).reshape(-1)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.zeros(cap, dtype=torch.bool, device=dev)
        validity[:total] = torch.stack([c.valid_mask()[:n] for c in cols], 1).reshape(-1)
    return Column(cols[0].dtype, data, validity, total, cols[0].dictionary)


def bools_to_mask(col: Column) -> Column:
    """cudf::bools_to_mask: a bool column whose validity is its own truth
    (a null or False row becomes a null)."""
    from ..core import dtypes

    v = col.data.to(torch.bool) & col.valid_mask()
    return Column(dtypes.bool_, v, v, col.length)


def row_bit_count(tbl: Table) -> Column:
    """cudf::row_bit_count: each row's storage bits, int32. A fixed-width
    value counts its width; a string its UTF-8 bytes times 8 plus a 32-bit
    offset; a column with a mask one bit more."""
    import numpy as np

    from ..core import dtypes

    cols = [c for _, c in tbl]
    cap, dev = cols[0].capacity, cols[0].device
    bits = torch.zeros(cap, dtype=torch.int32, device=dev)
    for c in cols:
        if c.dtype.is_string:
            d = c.dictionary if c.dictionary is not None else np.array([], object)
            lens = [len(s.encode()) * 8 for s in d] or [0]
            lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            per = lens[c.data.to(torch.int64).clamp(0, len(lens) - 1)] + 32
        else:
            per = torch.full((cap,), c.data.element_size() * 8, dtype=torch.int32,
                             device=dev)
        bits += per + (1 if c.validity is not None else 0)
    return Column(dtypes.int32, bits, None, cols[0].length)
