"""Search: searchsorted (lower/upper bound) and contains (counterpart of
``cudf_tpu/ops/search.py``; libcudf's cpp/src/search/).

A vectorized lexicographic binary search over the row codes' equality
operands (``ops/rowcodes.py``): every needle takes log2(capacity) steps
together, each a gather from the haystack's operands.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..core import dtypes
from ..core.column import Column
from . import rowcodes


def _lex_lt(a_ops: Sequence[torch.Tensor], b_ops: Sequence[torch.Tensor]):
    """(a < b, a == b) lexicographically over paired operands."""
    lt = torch.zeros(a_ops[0].shape, dtype=torch.bool, device=a_ops[0].device)
    eq = torch.ones_like(lt)
    for a, b in zip(a_ops, b_ops):
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return lt, eq


def _operands(col: Column, with_null_flag: bool) -> List[torch.Tensor]:
    ops = rowcodes.equality_operands(col)
    if with_null_flag and col.validity is None:
        ops = [torch.zeros(col.capacity, dtype=torch.int64, device=col.device)] + ops
    return ops


def _searchsorted(haystack: Column, needles: Column, side: str) -> torch.Tensor:
    nullable = haystack.validity is not None or needles.validity is not None
    h_ops = _operands(haystack, nullable)
    n_ops = _operands(needles, nullable)
    cap_h = haystack.capacity
    lo = torch.zeros(needles.capacity, dtype=torch.int64, device=needles.device)
    hi = torch.full_like(lo, haystack.length)
    for _ in range(max(1, cap_h.bit_length())):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, cap_h - 1)
        lt, eq = _lex_lt([op[midc] for op in h_ops], n_ops)
        go_right = lt | eq if side == "right" else lt
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def searchsorted(haystack: Column, needles: Column, side: str = "left") -> Column:
    """Indices where needles insert into (sorted) haystack."""
    out = _searchsorted(haystack, needles, side).to(torch.int32)
    return Column(dtypes.int32, out, None, needles.length)


def contains(haystack: Column, needles: Column) -> Column:
    """cudf::contains: for each needle, does it appear in haystack? The
    haystack need not be sorted (it is sorted here)."""
    from .sorting import sort_column
    from .strings import unify_dictionaries

    if haystack.dtype.is_string:
        haystack, needles = unify_dictionaries([haystack, needles])
    sh = sort_column(haystack)
    lb = _searchsorted(sh, needles, "left")
    ub = _searchsorted(sh, needles, "right")
    return Column(dtypes.bool_, ub > lb, needles.validity, needles.length)
