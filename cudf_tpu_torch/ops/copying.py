"""Gather over padded columns (counterpart of ``cudf_tpu/ops/copying.py``)."""
from __future__ import annotations

import torch

from ..core.column import Column
from ..core.table import Table


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
