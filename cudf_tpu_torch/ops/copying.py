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
