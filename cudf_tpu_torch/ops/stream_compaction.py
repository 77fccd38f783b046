"""Stream compaction: apply_boolean_mask, drop_nulls.

Counterpart of ``cudf_tpu/ops/stream_compaction.py`` (cudf's
apply_boolean_mask.cu / drop_nulls.cu). Compaction is a stable partition:
the kept row positions, in order, from one ``torch.nonzero`` (whose size is
the one host sync, as in libcudf's size-returning kernels), then a gather
into a buffer of the survivors' capacity bucket. The reference's flag sort
and its lazy-length envelope exist for the TPU and are not copied.
``distinct`` and the chunked branch are later slices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.column import Column
from ..core.table import Table
from ..utils.padding import bucket_capacity


def _compact_column(col: Column, idx: torch.Tensor, n_out: int,
                    out_cap: int) -> Column:
    data = torch.zeros(out_cap, dtype=col.data.dtype, device=col.device)
    data[:n_out] = col.data[idx]
    validity = None
    if col.validity is not None:
        validity = torch.zeros(out_cap, dtype=torch.bool, device=col.device)
        validity[:n_out] = col.validity[idx]
    out = Column(col.dtype, data, validity, n_out, col.dictionary)
    # survivors are a SUBSET of the source's values: the source's stats are
    # a conservative-correct bound for key-code planning
    if col.stats is not None:
        out.stats = col.stats
    else:
        out.stats_ref = col.stats_ref if col.stats_ref is not None else col
    return out


def _compact(tbl: Table, keep: torch.Tensor) -> Table:
    """Keep rows where ``keep`` (bool[capacity], False past the length)."""
    idx = torch.nonzero(keep).squeeze(1)
    n_out = idx.numel()
    out_cap = bucket_capacity(n_out)
    return Table({n: _compact_column(c, idx, n_out, out_cap) for n, c in tbl})


def apply_boolean_mask(tbl: Table, mask: Column) -> Table:
    """Keep rows where mask is true (null mask rows are dropped — cuDF)."""
    keep = mask.data.to(torch.bool) & mask.bounds_mask()
    if mask.validity is not None:
        keep &= mask.validity
    return _compact(tbl, keep)


def drop_nulls(tbl: Table, keys: Optional[Sequence[str]] = None,
               keep_threshold: Optional[int] = None) -> Table:
    """cudf::drop_nulls: keep rows with at least ``keep_threshold`` (default:
    all) non-null values among ``keys`` (default: every column)."""
    names = list(keys) if keys is not None else tbl.names
    if not names:
        return tbl
    thresh = len(names) if keep_threshold is None else keep_threshold
    first = tbl[names[0]]
    counts = torch.zeros(first.capacity, dtype=torch.int32, device=first.device)
    for n in names:
        v = tbl[n].validity
        counts += 1 if v is None else v.to(torch.int32)
    return _compact(tbl, (counts >= thresh) & first.bounds_mask())
