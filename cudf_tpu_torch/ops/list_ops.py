"""List-column operations: contains, dedup, sort and row-wise set ops
(counterpart of ``cudf_tpu/ops/list_ops.py``).

Analog of cpp/src/lists/ (contains.cu, set_operations.cu,
drop_list_duplicates, segmented sort of list entries). Each op composes
(a) the parent id of every child element, (b) one stable multi-operand
sort keyed by (parent, value codes), (c) adjacency compares and scatters
for runs and per-row counts, and (d) a stable compaction of the kept
elements. String children on two dictionaries are recoded onto their
union first (``_align_string_children``), so values compare by code.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.lists import ListColumn
from ..utils.padding import bucket_capacity
from . import rowcodes
from .sortprim import multisort_perm


def _compact(values: Column, parents: torch.Tensor, keep: torch.Tensor,
             n_rows: int) -> Tuple[torch.Tensor, Column]:
    """The kept child elements, in order, and offsets rebuilt from the
    per-parent counts."""
    idx = torch.nonzero(keep).squeeze(1)
    total = idx.shape[0]
    cap = bucket_capacity(total)
    data = torch.zeros(cap, dtype=values.data.dtype, device=values.device)
    data[:total] = values.data[idx]
    v = None
    if values.validity is not None:
        v = torch.zeros(cap, dtype=torch.bool, device=values.device)
        v[:total] = values.validity[idx]
    counts = torch.zeros(n_rows + 1, dtype=torch.int64, device=values.device)
    counts.index_add_(0, parents[idx].clamp(0, n_rows), torch.ones_like(idx))
    offsets = torch.zeros(n_rows + 1, dtype=torch.int32, device=values.device)
    offsets[1:] = torch.cumsum(counts[:n_rows], 0).to(torch.int32)
    return offsets, Column(values.dtype, data, v, total, values.dictionary)


def _payload_ops(col: Column):
    """The value operands alone, without a null flag."""
    ops = rowcodes.equality_operands(col)
    return ops[1:] if col.validity is not None else ops


def list_contains(lc: ListColumn, value) -> Column:
    """Per-row bool: does the list hold ``value`` (lists::contains)."""
    n = lc.length
    cap = lc.capacity
    dev = lc.device
    child = lc.child
    if child.dtype.is_string:
        d = child.dictionary if child.dictionary is not None else np.array([], str)
        idx = int(np.searchsorted(d, value))
        if not (idx < len(d) and d[idx] == value):
            return Column(dtypes.bool_, torch.zeros(cap, dtype=torch.bool, device=dev),
                          lc.validity, n)
        eq = child.data.to(torch.int64) == idx
    else:
        target = Column.from_scalar(value, 1, child.dtype, device=dev)
        eq = torch.ones(child.capacity, dtype=torch.bool, device=dev)
        for op, t in zip(_payload_ops(child), _payload_ops(target)):
            eq &= op == t[0]
    eq &= child.valid_mask()
    hit = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    parents = torch.where(eq, lc.parent_ids(), cap)
    hit[parents] = True
    return Column(dtypes.bool_, hit[:cap], lc.validity, n)


def _sorted_runs(ops, parents: torch.Tensor, live: torch.Tensor, extra=()):
    """Stable order of the child elements by (parent, value operands,
    *extra), the ``live`` ones first, and the first live element of each
    (parent, value) run."""
    big = torch.iinfo(torch.int64).max
    keyed = [torch.where(live, o, big) for o in [parents] + list(ops)]
    perm = multisort_perm(keyed + [torch.where(live, e, big) for e in extra])
    first = rowcodes.adjacent_neq([o[perm] for o in keyed])
    return perm, first & live[perm]


def list_unique(lc: ListColumn) -> ListColumn:
    """Distinct elements of each list (drop_list_duplicates), in ascending
    value order as the reference gives them (nulls last, one kept)."""
    parents = lc.parent_ids()
    c = lc.child
    perm, keep = _sorted_runs(rowcodes.equality_operands(c), parents, c.bounds_mask())
    sc = Column(c.dtype, c.data[perm], None if c.validity is None else c.validity[perm],
                c.length, c.dictionary)
    offsets, child = _compact(sc, parents[perm], keep, lc.length)
    return ListColumn(offsets, child, lc.length, lc.validity)


def list_sort(lc: ListColumn, descending: bool = False, nulls_last: bool = True) -> ListColumn:
    """Sort each list's elements (lists::sort_lists) by a segmented sort."""
    from .sorting import segmented_sorted_order

    perm = segmented_sorted_order([lc.child], lc.offsets, descending, nulls_last)
    c = lc.child
    child = Column(c.dtype, c.data[perm], None if c.validity is None else c.validity[perm],
                   c.length, c.dictionary)
    return ListColumn(lc.offsets, child, lc.length, lc.validity)


def _align_string_children(a: ListColumn, b: ListColumn):
    """Recode both children onto their union dictionary (sorted)."""
    from .strings import unify_dictionaries

    ca, cb = unify_dictionaries([a.child, b.child])
    return (ListColumn(a.offsets, ca, a.length, a.validity),
            ListColumn(b.offsets, cb, b.length, b.validity))


def _setop(a: ListColumn, b: ListColumn, op: str) -> ListColumn:
    if a.length != b.length:
        raise ValueError("list set ops are row-wise: the columns' lengths differ")
    if a.child.dtype.is_string or b.child.dtype.is_string:
        a, b = _align_string_children(a, b)
    n = a.length
    dev = a.device
    na, nb = a.child.length, b.child.length
    total = na + nb
    cap = bucket_capacity(total)
    data = torch.zeros(cap, dtype=a.child.data.dtype, device=dev)
    data[:na] = a.child.data[:na]
    data[na:total] = b.child.data[:nb].to(data.dtype)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:na] = a.child.valid_mask()[:na]
    valid[na:total] = b.child.valid_mask()[:nb]
    parents = torch.zeros(cap, dtype=torch.int64, device=dev)
    parents[:na] = a.parent_ids()[:na]
    parents[na:total] = b.parent_ids()[:nb]
    src_b = torch.zeros(cap, dtype=torch.int64, device=dev)
    src_b[na:total] = 1
    # null elements take no part, as in the reference
    merged = Column(a.child.dtype, data, None, cap, a.child.dictionary)
    perm, first = _sorted_runs(rowcodes.equality_operands(merged), parents, valid, (src_b,))
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    sb, sin = src_b[perm], valid[perm]
    has_a = torch.zeros(cap, dtype=torch.bool, device=dev)
    has_b = torch.zeros(cap, dtype=torch.bool, device=dev)
    has_a[run[(sb == 0) & sin]] = True
    has_b[run[(sb == 1) & sin]] = True
    ra, rb = has_a[run], has_b[run]
    keep = {"union": first, "intersect": first & ra & rb,
            "difference": first & ra & ~rb}[op]
    sc = Column(a.child.dtype, data[perm], valid[perm], cap, a.child.dictionary)
    offsets, child = _compact(sc, parents[perm], keep, n)
    v = a.validity
    if b.validity is not None:
        v = b.validity if v is None else v & b.validity
    return ListColumn(offsets, child, n, v)


def list_union(a: ListColumn, b: ListColumn) -> ListColumn:
    """Row-wise distinct union (lists::union_distinct)."""
    return _setop(a, b, "union")


def list_intersect(a: ListColumn, b: ListColumn) -> ListColumn:
    """Row-wise distinct intersection (lists::intersect_distinct)."""
    return _setop(a, b, "intersect")


def list_difference(a: ListColumn, b: ListColumn) -> ListColumn:
    """Row-wise distinct a minus b (lists::difference_distinct)."""
    return _setop(a, b, "difference")


def list_overlap(a: ListColumn, b: ListColumn) -> Column:
    """Per-row bool: any common element (lists::have_overlap)."""
    lens = list_intersect(a, b).lengths()
    return Column(dtypes.bool_, lens.data > 0, lens.validity, a.length)
