"""Grouped window functions: per-group scans, shift (lead/lag), row
numbers and grouped rolling aggregates (counterpart of
``cudf_tpu/ops/grouped_window.py``).

Analog of cpp/src/rolling/grouped_rolling.cu and the LEAD/LAG/ROW_NUMBER
aggregation kinds. One stable key sort makes each group contiguous (with
its rows in their original order), the window runs over the sorted rows
with each group's start as a boundary, and the results scatter back to
the original row order.

Faults of the reference not copied: a grouped rolling ``count`` as in
``ops/rolling.py``, and its grouped ``cummax``, which offsets each
group's values by group_index·1e18 in f64 to restart the running max,
which rounds away every fraction after the first group; here the running
max restarts at each group exactly (a doubling scan that combines only
rows of one group), so the values equal pandas'.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from . import rowcodes
from .sortprim import multisort_perm


def _layout(tbl: Table, keys: Sequence[str]):
    """(key columns, perm, group start of each sorted row, in-bounds mask of
    the sorted rows): a stable sort by key, so the rows of a group keep
    their original order."""
    kcols = [tbl[k] for k in keys]
    length = kcols[0].length
    ops = rowcodes.grouping_operands(kcols, length)
    perm = multisort_perm(ops)
    newgrp = rowcodes.adjacent_neq([op[perm] for op in ops])
    pos = torch.arange(kcols[0].capacity, device=perm.device)
    # each row's latest group start: the starts, indexed by a running count
    # of them (a prefix sum; torch's cummax scan took ~0.4 s at 2^27 rows
    # on the H100)
    grp_start = pos[newgrp][torch.cumsum(newgrp, 0) - 1]
    return perm, grp_start, pos < length


def _scatter_back(perm, out: torch.Tensor, outv: torch.Tensor):
    res = torch.zeros_like(out)
    res[perm] = out
    resv = torch.zeros_like(outv)
    resv[perm] = outv
    return res, resv


def _sorted_values(vcol: Column, perm, inb):
    sv = vcol.data[perm]
    svalid = inb if vcol.validity is None else inb & vcol.validity[perm]
    return sv, svalid


def _segmented_cummax(x: torch.Tensor, grp_start: torch.Tensor) -> torch.Tensor:
    """Running max that restarts at each group start: doubling steps that
    combine a row only with rows of its own group."""
    pos = torch.arange(x.shape[0], device=x.device)
    d = 1
    while d < x.shape[0]:
        prev = torch.cat([x.new_full((d,), float("-inf")), x[:-d]])
        x = torch.where(pos - d >= grp_start, torch.maximum(x, prev), x)
        d *= 2
    return x


def grouped_scan(tbl: Table, keys: Sequence[str], value: str, kind: str) -> Column:
    """Per-group scan (cumsum/cumcount/row_number/cummax) in row order."""
    vcol = tbl[value]
    perm, grp_start, inb = _layout(tbl, keys)
    sv, svalid = _sorted_values(vcol, perm, inb)
    pos = torch.arange(vcol.capacity, device=perm.device)
    if kind in ("cumsum", "cumcount"):
        if kind == "cumsum":
            acc = torch.float64 if vcol.dtype.is_floating else torch.int64
            x = torch.where(svalid, sv.to(acc), torch.zeros((), dtype=acc, device=sv.device))
        else:
            x = svalid.to(torch.int64)
        cs = torch.cumsum(x, 0)
        base = torch.where(grp_start > 0, cs[(grp_start - 1).clamp(min=0)],
                           torch.zeros((), dtype=cs.dtype, device=cs.device))
        out = cs - base
        out_dt = (vcol.dtype if kind == "cumsum" and vcol.dtype.is_floating
                  else dtypes.int64)
        outv = svalid if kind == "cumsum" else inb
    elif kind == "row_number":
        out, out_dt, outv = pos - grp_start + 1, dtypes.int64, inb
    elif kind == "cummax":
        out = _segmented_cummax(torch.where(svalid, sv.to(torch.float64), float("-inf")),
                                grp_start)
        out_dt, outv = dtypes.float64, svalid
    else:
        raise ValueError(kind)
    res, resv = _scatter_back(perm, out.to(out_dt.physical), outv)
    return Column(out_dt, res, resv, vcol.length)


def grouped_shift(tbl: Table, keys: Sequence[str], value: str, periods: int = 1) -> Column:
    """groupby().shift(periods): the LEAD/LAG aggregation analog."""
    vcol = tbl[value]
    cap = vcol.capacity
    perm, grp_start, inb = _layout(tbl, keys)
    sv, svalid = _sorted_values(vcol, perm, inb)
    pos = torch.arange(cap, device=perm.device)
    src = pos - periods
    srcc = src.clamp(0, cap - 1)
    if periods >= 0:
        ok = src >= grp_start
    else:
        ok = (src < cap) & (grp_start[srcc] == grp_start)
    out = torch.where(ok, sv[srcc], torch.zeros((), dtype=sv.dtype, device=sv.device))
    res, resv = _scatter_back(perm, out, ok & svalid[srcc] & inb)
    return Column(vcol.dtype, res, resv, vcol.length, vcol.dictionary)


def grouped_rolling(tbl: Table, keys: Sequence[str], value: str, window: int,
                    kind: str = "sum", min_periods: Optional[int] = None) -> Column:
    """groupby().rolling(window).agg: the grouped_rolling_window analog
    (sum/mean/count), windows clipped to the group start."""
    vcol = tbl[value]
    perm, grp_start, inb = _layout(tbl, keys)
    sv, svalid = _sorted_values(vcol, perm, inb)
    if vcol.dtype.is_floating:
        svalid = svalid & ~torch.isnan(sv)
    pos = torch.arange(vcol.capacity, device=perm.device)
    csum = torch.cumsum(torch.where(svalid, sv.to(torch.float64), 0.0), 0)
    ccnt = torch.cumsum(svalid.to(torch.int64), 0)
    begin = torch.maximum(pos - window + 1, grp_start)
    prev = (begin - 1).clamp(min=0)
    wsum = csum - torch.where(begin > 0, csum[prev], 0.0)
    wcnt = ccnt - torch.where(begin > 0, ccnt[prev], 0)
    mp = window if min_periods is None else min_periods
    if kind == "sum":
        out = wsum
    elif kind == "mean":
        out = wsum / wcnt.clamp(min=1)
    elif kind == "count":
        out = wcnt.to(torch.float64)
    else:
        raise ValueError(kind)
    # pandas: a count's min_periods counts the window's rows, valid or not
    have = pos - begin + 1 if kind == "count" else wcnt
    outv = (have >= mp) & inb
    res, resv = _scatter_back(perm, torch.where(outv, out, float("nan")), outv)
    return Column(dtypes.float64, res, resv, vcol.length)
