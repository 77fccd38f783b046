"""Filling, sequences, labeling (binning) and reshape (counterpart of
``cudf_tpu/ops/filling.py``).

Analogs: cpp/src/filling/ (fill, sequence), cpp/src/labeling/label_bins.cu
(pandas.cut), cpp/src/reshape and cpp/src/transpose. Every op runs on the
device of its input; ``sequence``, which has none, takes ``device``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column, resolve_device
from ..core.table import Table
from ..utils.padding import bucket_capacity


def sequence(size: int, init=0, step=1, dtype=dtypes.int64, device=None) -> Column:
    """cudf::sequence: ``init, init + step, ...`` for ``size`` rows."""
    dev = resolve_device(device)
    cap = bucket_capacity(max(size, 1))
    data = (torch.arange(cap, dtype=torch.float64 if dtype.is_floating else torch.int64,
                         device=dev) * step + init).to(dtype.physical)
    return Column(dtype, data, None, size)


def fill(col: Column, begin: int, end: int, value) -> Column:
    """cudf::fill: set rows [begin, end) to a scalar (None: to null)."""
    pos = torch.arange(col.capacity, device=col.device)
    m = (pos >= begin) & (pos < end)
    if value is None:
        v = col.validity if col.validity is not None else torch.ones_like(m)
        return Column(col.dtype, col.data, v & ~m, col.length, col.dictionary)
    fillv = torch.tensor(col.dtype.numpy_physical.type(value).item(),
                         dtype=col.data.dtype, device=col.device)
    return Column(col.dtype, torch.where(m, fillv, col.data), col.validity,
                  col.length, col.dictionary)


def label_bins(col: Column, edges: Sequence[float], right: bool = True,
               include_lowest: bool = True) -> Column:
    """cudf::label_bins (pandas.cut labels; null outside the range)."""
    e = torch.tensor(np.asarray(edges, np.float64), device=col.device)
    x = col.data.to(torch.float64)
    lab = torch.searchsorted(e, x, right=not right).to(torch.int32) - 1
    valid = (lab >= 0) & (lab < e.shape[0] - 1)
    if include_lowest:
        at_low = x == e[0]
        lab = torch.where(at_low, 0, lab)
        valid = valid | at_low
    return Column(dtypes.int32, lab, col.valid_mask() & valid, col.length)


def transpose(tbl: Table) -> Table:
    """cudf::transpose: same-dtype columns only (a host round trip, as in
    the reference)."""
    mat = np.stack([c.to_numpy() for c in tbl.columns])
    dev = tbl.device
    return Table({str(i): Column.from_numpy(mat[:, i], device=dev)
                  for i in range(mat.shape[1])})


def tile(tbl: Table, count: int) -> Table:
    """cudf::tile: the table's rows ``count`` times over."""
    from .copying import concatenate_tables

    return concatenate_tables([tbl] * count)


def repeat(tbl: Table, repeats: int) -> Table:
    """cudf::repeat with a scalar count: each row ``repeats`` times."""
    from .copying import gather_table

    total = tbl.num_rows * repeats
    idx = torch.arange(bucket_capacity(max(total, 1)), device=tbl.device) // max(repeats, 1)
    return gather_table(tbl, idx, total)


def one_hot_encode(col: Column) -> Table:
    """cudf::one_hot_encode over the column's distinct values."""
    from .binaryop import binary_op
    from .stream_compaction import distinct

    uniq = distinct(Table({"v": col}))["v"]
    return Table({str(c): binary_op(col, c, "eq") for c in uniq.to_numpy()})


def qcut_labels(col: Column, q: int) -> Column:
    """Quantile-based bin labels (pandas.qcut with labels=False)."""
    from .reductions import reduce as _reduce, to_scalar

    edges = [to_scalar(_reduce(col, "quantile", i / q)) for i in range(q + 1)]
    return label_bins(col, edges, right=True, include_lowest=True)


def _ffill(col: Column) -> Column:
    """Each row takes the last valid (non-null, non-NaN) value at or before
    it: a cummax of valid positions picks the source row."""
    cap = col.capacity
    pos = torch.arange(cap, device=col.device)
    valid = col.validity if col.validity is not None else torch.ones(
        cap, dtype=torch.bool, device=col.device)
    if col.dtype.is_floating:
        valid = valid & ~torch.isnan(col.data)
    src = torch.cummax(torch.where(valid, pos, -1), 0).values
    has = src >= 0
    data = col.data[src.clamp(0, cap - 1)]
    validity = has if col.validity is not None else None
    if col.dtype.is_floating:
        data = torch.where(has, data, torch.full((), float("nan"), dtype=data.dtype,
                                                 device=data.device))
    return Column(col.dtype, data, validity, col.length, col.dictionary)


def fill_forward(col: Column) -> Column:
    """pandas ffill: propagate the last valid value forward
    (cpp/src/replace/nulls.cu replace_nulls(replace_policy::PRECEDING))."""
    return _ffill(col)


def fill_backward(col: Column) -> Column:
    """pandas bfill (replace_policy::FOLLOWING): ffill on the reversed rows."""
    return _reverse(_ffill(_reverse(col)))


def _reverse(col: Column) -> Column:
    """The logical rows in reverse order; padding rows stay in place."""
    n = col.length
    pos = torch.arange(col.capacity, device=col.device)
    src = torch.where(pos < n, n - 1 - pos, pos)
    validity = None if col.validity is None else col.validity[src]
    return Column(col.dtype, col.data[src], validity, n, col.dictionary)
