"""Sorting: sorted_order, sort_by_key, rank, top-k, segmented sort
(counterpart of ``cudf_tpu/ops/sorting.py``; libcudf's cpp/src/sort/).

Every order is a stable lexicographic sort of the keys' row codes (one
int64 code a key, a null-flag operand for a nullable key, complemented
codes for descending) by ``sortprim.multisort_perm``, then
``gather_table``. The codes are canonical: nulls are equal whatever lies
under them, -0 equals +0 and NaNs are equal, as in cuDF, pandas and the
reference's engine sort (``sort_by_key``'s code lane). The reference's
``sorted_order`` differs on two points that the port does not copy
(ROADMAP section 3): it orders null rows by the payload hidden under the
null, and an f32 -0 before +0. Padding rows must sort
last; the reference gives them a leading out-of-bounds operand, which here
would cost one more sort pass over the whole buffer. Instead every operand
of a padding row is set to INT64_MAX: the padding tuple is then the largest,
and a stable sort keeps it after any real row equal to it. The permutation
over the real rows is the reference's.

Not copied from the reference, which built them around the TPU: the
payload-carrying word lanes (``_fast_sort_by_key``, ``_sort_code_plan``,
``_order_ops``, ``build_order_words``, ``sort_payloads_by_words``).
``sort_by_key`` past the memory it may use sorts chunk by chunk
(``ops/chunked.py``) and gives the same permutation. ``rank`` takes each
group's start and end from a prefix sum of the group flags and a gather,
where the reference runs cummax/cummin scans (torch's cummax took 398 ms
over 2^27 rows on an H100).
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from . import rowcodes
from .copying import gather, gather_table
from .sortprim import multisort_perm, tiled_cumsum

_I64_MAX = (1 << 63) - 1


def _norm_flags(n: int, flag: Union[bool, Sequence[bool]]) -> List[bool]:
    if isinstance(flag, (list, tuple)):
        assert len(flag) == n
        return list(flag)
    return [bool(flag)] * n


def _order_operands(keys: Sequence[Column], desc, nl) -> List[torch.Tensor]:
    """Sort operands of the keys, every operand INT64_MAX on padding rows.

    Each key's operands are its canonical equality codes
    (``rowcodes.equality_operands``, which are also order codes): a null's
    hidden payload reads as 0, -0 equals +0 and every NaN is one value,
    the largest; then the null flag flips for nulls first and the code is
    complemented for descending."""
    ops = []
    for c, d, n in zip(keys, desc, nl):
        key_ops = rowcodes.equality_operands(c)
        if c.validity is not None and not n:
            key_ops[0] = 1 - key_ops[0]
        if d:
            key_ops[-1] = ~key_ops[-1]
        ops.extend(key_ops)
    length = keys[0].length
    if length < keys[0].capacity:
        ops = [op.clone() for op in ops]
        for op in ops:
            op[length:] = _I64_MAX
    return ops


def sorted_order(keys: Sequence[Column],
                 descending: Union[bool, Sequence[bool]] = False,
                 nulls_last: Union[bool, Sequence[bool]] = True) -> torch.Tensor:
    """Stable permutation (int64[capacity]) ordering the key columns."""
    keys = list(keys)
    desc = _norm_flags(len(keys), descending)
    nl = _norm_flags(len(keys), nulls_last)
    return multisort_perm(_order_operands(keys, desc, nl))


def sort_by_key(tbl: Table, keys: Sequence[str],
                descending: Union[bool, Sequence[bool]] = False,
                nulls_last: Union[bool, Sequence[bool]] = True) -> Table:
    from .chunked import SORT_FACTOR, chunk_rows, chunked_sort_by_key

    rows = chunk_rows(tbl, SORT_FACTOR)
    if rows is not None:
        return chunked_sort_by_key(tbl, list(keys), _norm_flags(len(keys), descending),
                                   _norm_flags(len(keys), nulls_last), rows)
    perm = sorted_order([tbl[k] for k in keys], descending, nulls_last)
    return gather_table(tbl, perm, tbl.num_rows)


def sort_column(col: Column, descending: bool = False, nulls_last: bool = True) -> Column:
    perm = sorted_order([col], descending, nulls_last)
    return gather(col, perm, col.length)


def top_k(tbl: Table, k: int, keys: Sequence[str], largest: bool = True) -> Table:
    """cudf::top_k (cpp/src/sort/top_k.cu): sort, then the first k rows."""
    return sort_by_key(tbl, keys, descending=largest).slice(0, k)


def rank(col: Column, method: str = "min", descending: bool = False,
         pct: bool = False) -> Column:
    """cudf::rank (cpp/src/sort/rank.cu): average/min/max/first/dense; nulls
    sort last and stay null."""
    if method not in ("first", "dense", "min", "max", "average"):
        raise ValueError(method)
    cap, n = col.capacity, col.length
    dev = col.device
    perm = sorted_order([col], descending, True)
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    new_grp = rowcodes.adjacent_neq([op[perm] for op in rowcodes.equality_operands(col)])
    new_grp |= pos == n  # padding (sorted last) never joins a real group
    gid = tiled_cumsum(new_grp) - 1
    if method == "first":
        r_sorted = pos + 1
    elif method == "dense":
        r_sorted = gid + 1
    else:
        starts = torch.nonzero(new_grp).squeeze(1)
        grp_start = starts[gid]
        grp_end = (torch.cat([starts[1:], starts.new_full((1,), cap)]) - 1)[gid]
        if method == "min":
            r_sorted = grp_start + 1
        elif method == "max":
            r_sorted = grp_end + 1
        else:
            r_sorted = (grp_start + grp_end).to(torch.float64) / 2 + 1
    out = torch.empty_like(r_sorted)
    out[perm] = r_sorted
    if pct:
        valid_n = n if col.validity is None else col.valid_mask().sum()
        return Column(dtypes.float64, out.to(torch.float64) / valid_n, col.validity, n)
    out_dt = dtypes.float64 if method == "average" else dtypes.int64
    return Column(out_dt, out.to(out_dt.physical), col.validity, n)


def segmented_sorted_order(keys: Sequence[Column], offsets,
                           descending: Union[bool, Sequence[bool]] = False,
                           nulls_last: Union[bool, Sequence[bool]] = True) -> torch.Tensor:
    """Stable within-segment ordering permutation. ``offsets`` are segment
    start offsets (segment i covers rows [offsets[i], offsets[i+1])); rows
    stay inside their segment, and the keys order them within it."""
    keys = list(keys)
    desc = _norm_flags(len(keys), descending)
    nl = _norm_flags(len(keys), nulls_last)
    cap = keys[0].capacity
    dev = keys[0].device
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int64)
    seg = torch.searchsorted(offsets, torch.arange(cap, device=dev), right=True)
    return multisort_perm([seg] + _order_operands(keys, desc, nl))


def segmented_sort_by_key(tbl: Table, keys: Sequence[str], offsets,
                          descending: Union[bool, Sequence[bool]] = False,
                          nulls_last: Union[bool, Sequence[bool]] = True) -> Table:
    perm = segmented_sorted_order([tbl[k] for k in keys], offsets, descending,
                                  nulls_last)
    return gather_table(tbl, perm, tbl.num_rows)
