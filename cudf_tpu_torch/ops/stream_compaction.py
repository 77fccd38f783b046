"""Stream compaction: apply_boolean_mask, drop_nulls, distinct.

Counterpart of ``cudf_tpu/ops/stream_compaction.py`` (cudf's
apply_boolean_mask.cu / drop_nulls.cu / distinct.cu). Compaction is a
stable partition: the kept row positions, in order, from one
``torch.nonzero`` (whose size is the one host sync, as in libcudf's
size-returning kernels), then a gather into a buffer of the survivors'
capacity bucket. The reference's flag sort and its lazy-length envelope
exist for the TPU and are not copied. ``distinct`` takes the reference's
default sort lane; its opt-in hash-table lane (``_distinct_pallas``) gives
the same keep mask for keep="first" and is not copied. Past the memory an
op may use, the compaction runs chunk by chunk (``ops/chunked.py``).

Fault of the reference not copied: its ``keep="none"`` keeps the first
occurrence, as ``"first"`` does; here it keeps only keys that occur once.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..utils.padding import bucket_capacity
from ..utils.tracing import trace_op
from . import rowcodes
from .sortprim import multisort_perm


def _compact_column(col: Column, idx: torch.Tensor, n_out: int,
                    out_cap: int) -> Column:
    data = torch.zeros(out_cap, dtype=col.data.dtype, device=col.device)
    data[:n_out] = col.data[idx]
    validity = None
    if col.validity is not None:
        validity = torch.zeros(out_cap, dtype=torch.bool, device=col.device)
        validity[:n_out] = col.validity[idx]
    out = Column(col.dtype, data, validity, n_out, col.dictionary)
    carry_stats(col, out)
    return out


def carry_stats(src: Column, out: Column) -> None:
    """Survivors are a subset of the source's values: the source's stats
    are a conservative bound for key-code planning."""
    if src.stats is not None:
        out.stats = src.stats
    else:
        out.stats_ref = src.stats_ref if src.stats_ref is not None else src


def _compact(tbl: Table, keep: torch.Tensor) -> Table:
    """Keep rows where ``keep`` (bool[capacity], False past the length);
    past the memory the op may use, chunk by chunk (``ops/chunked.py``)."""
    from .chunked import COMPACT_FACTOR, chunk_rows, chunked_compact

    rows = chunk_rows(tbl, COMPACT_FACTOR)
    if rows is not None:
        return chunked_compact(tbl, keep, rows)
    idx = torch.nonzero(keep).squeeze(1)
    n_out = idx.numel()
    out_cap = bucket_capacity(n_out)
    return Table({n: _compact_column(c, idx, n_out, out_cap) for n, c in tbl})


def _mask_keep(mask: Column) -> torch.Tensor:
    keep = mask.data.to(torch.bool) & mask.bounds_mask()
    if mask.validity is not None:
        keep &= mask.validity
    return keep


@trace_op
def apply_boolean_mask(tbl: Table, mask: Column) -> Table:
    """Keep rows where mask is true (null mask rows are dropped — cuDF)."""
    return _compact(tbl, _mask_keep(mask))


def compact_known_count(tbl: Table, mask: Column, n_out: int) -> Table:
    """apply_boolean_mask with the survivor count known on the host: no
    host read. Each kept row's output slot is the running count of kept
    rows before it; one scatter sends the row ids there (dropped rows to a
    slot past the end). Callers that batch many small compactions read
    all their counts at once, then compact."""
    keep = _mask_keep(mask)
    dst = torch.where(keep, torch.cumsum(keep, 0) - 1, n_out).clamp(max=n_out)
    idx = torch.zeros(n_out + 1, dtype=torch.int64, device=keep.device)
    idx.scatter_(0, dst, torch.arange(keep.shape[0], device=keep.device))
    out_cap = bucket_capacity(max(n_out, 1))
    return Table({n: _compact_column(c, idx[:n_out], n_out, out_cap) for n, c in tbl})


def filter_column(col: Column, mask: Column) -> Column:
    """The rows of ``col`` where ``mask`` is true (a null mask row drops)."""
    return apply_boolean_mask(Table({"c": col}), mask)["c"]


def drop_nans(tbl: Table, keys: Optional[Sequence[str]] = None) -> Table:
    """Drop rows with a NaN in any float column among ``keys`` (default:
    every column)."""
    names = list(keys) if keys is not None else tbl.names
    first = tbl[names[0]]
    keep = first.bounds_mask()
    for n in names:
        c = tbl[n]
        if c.dtype.is_floating:
            keep = keep & ~torch.isnan(c.data)
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


def _grouping_codes(keys, last: bool = False):
    """Operands of the distinct sort; ``last`` adds a descending-position
    tiebreak so each key's last occurrence sorts first in its run."""
    ops = rowcodes.grouping_operands(keys, keys[0].length)
    if last:
        cap = keys[0].capacity
        ops = ops + [cap - 1 - torch.arange(cap, device=keys[0].device)]
    return ops


def _first_occurrence_finish(keys, perm, only_unique: bool = False):
    """bool[cap] marking the row that leads each distinct-key run (with
    ``only_unique``, only runs of one row)."""
    cap = keys[0].capacity
    sorted_ops = [op[perm] for op in rowcodes.grouping_operands(keys, keys[0].length)]
    newgrp = rowcodes.adjacent_neq(sorted_ops)
    lead = newgrp
    if only_unique:
        next_new = torch.ones_like(newgrp)
        next_new[:-1] = newgrp[1:]
        lead = newgrp & next_new
    keep = torch.zeros(cap, dtype=torch.bool, device=perm.device)
    keep[perm] = lead
    return keep & keys[0].bounds_mask()


def _distinct_perm(kcols, keep: str) -> torch.Tensor:
    if keep not in ("first", "last", "none"):
        raise ValueError(f"keep must be first, last or none, got {keep!r}")
    perm = multisort_perm(_grouping_codes(kcols, last=(keep == "last")))
    return _first_occurrence_finish(kcols, perm, only_unique=(keep == "none"))


def distinct(tbl: Table, keys: Optional[Sequence[str]] = None,
             keep: str = "first") -> Table:
    """cudf::distinct / stable_distinct (distinct.cu): one row per key, the
    first or last occurrence; ``keep="none"`` keeps only keys that occur
    once (cuDF's KEEP_NONE, pandas ``keep=False``). Null keys and NaNs
    compare equal. Output keeps the input's row order."""
    names = list(keys) if keys is not None else tbl.names
    return _compact(tbl, _distinct_perm(tuple(tbl[n] for n in names), keep))


def unique_count(keys: Sequence[Column]) -> int:
    return int(_distinct_perm(tuple(keys), "first").sum().item())


def distinct_mask(tbl: Table, keys: Optional[Sequence[str]] = None,
                  keep: str = "first") -> Column:
    """bool keep-mask in the original row order: True where the row is the
    kept occurrence of its key."""
    names = list(keys) if keys is not None else tbl.names
    first = tbl[names[0]]
    return Column(dtypes.bool_, _distinct_perm(tuple(tbl[n] for n in names), keep),
                  None, first.length)
