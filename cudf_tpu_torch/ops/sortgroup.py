"""Single-word code-sort groupby (counterpart of ``cudf_tpu/ops/sortgroup.py``).

  1. key columns compress to exact integer codes from cached stats (64-bit
     integers keep exact Python-int bounds), packed into ONE word of <= 63
     code bits under a leading inactive-sentinel bit, so sparse 64-bit keys
     fit;
  2. one stable sort by that word (as int64 with the top bit flipped, so
     signed order is the word's unsigned order);
  3. sums, counts and M2 are per-group sums over the sorted rows, each
     adding only its own group's rows in a fixed order, and the order
     statistics per-group reductions (``fastgroup.build_scan_arrays``);
  4. the group-END rows, in key order, carry the key words and the sizes.

The reference takes a group's sum as the difference of two prefix sums
over the whole sorted table, which spreads a NaN into every later group and
costs a small group the precision of the running total; the sums here do
neither.

The reference also splits this path past ``SORT_OPERAND_MAX`` to cap TPU
compile time; the GPU has no such limit and runs one path, whose results
match both of the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..core import dtypes
from ..core import stats as colstats
from ..core.column import Column
from ..core.table import Table
from . import fastgroup
from .fastgroup import _I64_MIN, _dtype_of, padded_column

_SUPPORTED = {
    "sum", "product", "min", "max", "count", "size", "any", "all", "mean",
    "sum_of_squares", "first", "last", "nth", "var", "std", "m2",
}

MAX_CODE_BITS = 63  # one 64-bit word minus the inactive-sentinel bit


def plan_wide(kcols: Sequence[Column]):
    """Per-key (stats, width) with EXACT wide codes, total <= MAX_CODE_BITS;
    None when any key is not integral-codeable or the pack is too wide."""
    plan = []
    total = 0
    for c in kcols:
        st = colstats.compute_stats(c)
        if st is None:
            return None
        w = st.code_width_wide()
        if w is None:
            return None
        plan.append((st, w))
        total += w
    if total > MAX_CODE_BITS:
        return None
    return plan


def _make_word(kcols: Sequence[Column], plan, dropna: bool):
    """(word, active): int64 [sentinel:1][packed codes:tbits] with the top
    bit flipped; the sentinel marks padding / dropped-null rows (sort last)."""
    slot, active = fastgroup._make_key(kcols, plan, dropna)
    tbits = sum(w for _, w in plan)
    return torch.where(active, slot ^ _I64_MIN, (1 << tbits) + _I64_MIN), active


def _pass1(word, vcols, kinds, tbits):
    """Sort rows by key word; build the per-group arrays."""
    skey, spos = torch.sort(word, stable=True)
    act = skey < (1 << tbits) + _I64_MIN
    newgrp, seg, n_groups, n_active = fastgroup._group_ids(skey, act)
    starts, lengths = fastgroup.group_starts(newgrp, n_active)
    sums = fastgroup.GroupSums(seg, lengths, n_active)
    arrs_by_col = []
    for c, kset in zip(vcols, kinds):
        sval = c.validity[spos] if c.validity is not None else None
        arrs_by_col.append(fastgroup.build_scan_arrays(
            c.data[spos], sval, act, seg, n_groups, sums, kset))
    return (skey ^ _I64_MIN)[starts], n_groups, lengths, arrs_by_col


def _finalize_body(gcode, arrs_by_col, lengths, n_groups, aggs, agg_vidx,
                   vcols, kcols, keynames, plan) -> Dict[str, Column]:
    """Group answers from each group's key code and per-group arrays."""
    out = fastgroup.decode_keys(keynames, kcols, plan, gcode, n_groups)

    for spec, vidx in zip(aggs, agg_vidx):
        vcol = vcols[vidx]
        arrs = arrs_by_col[vidx]
        cnt = arrs["g_cnt"]
        validity = cnt > 0
        kind = spec.kind

        if kind == "size":
            data, dt, validity = lengths, dtypes.int64, None
        elif kind == "count":
            data, dt, validity = cnt, dtypes.int64, None
        elif kind == "sum_of_squares":
            data = arrs["g_sos"]
            dt = _dtype_of(data)
        elif kind == "sum":
            data = arrs["g_sum"]
            if vcol.dtype.is_floating and vcol.dtype.bits <= 32:
                data, dt = data.to(torch.float32), dtypes.float32
            else:
                dt = _dtype_of(data)
        elif kind == "mean":
            data = arrs["g_sum"].to(torch.float64) / cnt.clamp(min=1)
            dt = dtypes.float64
        elif kind in ("var", "std", "m2"):
            m2 = arrs["g_m2"]
            dt = dtypes.float64
            if kind == "m2":
                data = m2
            else:
                ddof = int(spec.param) if spec.param else 1
                denom = cnt - ddof
                var = torch.where(denom > 0, m2 / denom.clamp(min=1), float("nan"))
                validity = validity & (denom > 0)
                data = var if kind == "var" else torch.sqrt(var)
        elif kind == "product":
            data = arrs["prod"]
            dt = _dtype_of(data)
        elif kind in ("min", "max"):
            data = arrs["smin" if kind == "min" else "smax"]
            dt = vcol.dtype
        elif kind in ("any", "all"):
            data = arrs["sany" if kind == "any" else "sall"].to(torch.bool)
            dt = dtypes.bool_
        elif kind in ("first", "nth", "last"):
            sv_full = arrs["sv"]
            cap = sv_full.shape[0]
            if kind == "last":
                idx = arrs["slast"].clamp(0, cap - 1)
            else:
                idx = arrs["sfirst"].clamp(0, cap - 1)
                if kind == "nth":
                    idx = (idx + int(spec.param)).clamp(0, cap - 1)
            data, dt = sv_full[idx], vcol.dtype
        else:  # pragma: no cover - guarded by _SUPPORTED
            raise ValueError(kind)
        out[spec.out_name] = padded_column(dt, data, validity, n_groups,
                                           vcol.dictionary if dt == vcol.dtype else None)
    return out


def sort_groupby(tbl: Table, keys: Sequence[str], aggs,
                 dropna_keys: bool) -> Optional[Table]:
    """Single-word code-sort groupby; None when this plan doesn't apply."""
    if not all(s.kind in _SUPPORTED for s in aggs):
        return None
    kcols = [tbl[k] for k in keys]
    plan = plan_wide(kcols)
    if plan is None:
        return None
    tbits = sum(w for _, w in plan)
    word, _ = _make_word(kcols, plan, dropna_keys)
    vcols, kinds, agg_vidx = fastgroup._value_columns(tbl, keys, aggs)
    gcode, n_groups, lengths, arrs_by_col = _pass1(word, vcols, kinds, tbits)
    out = _finalize_body(gcode, arrs_by_col, lengths, n_groups, aggs, agg_vidx,
                         vcols, kcols, keys, plan)
    return Table({n: out[n] for n in list(keys) + [s.out_name for s in aggs]})
