"""Groupby-aggregate (counterpart of ``cudf_tpu/ops/groupby.py``).

Dispatch, in order:

  1. the one-hot kernel lane (``fastgroup._onehot_groupby``) when the keys
     pack into <= 11 code bits, every agg is sum/mean/count/size, and at
     most one value column, f32 (nulls allowed), is read — libcudf likewise
     takes its shared-memory single-pass aggregation when cardinality is
     small (compute_single_pass_aggs.cuh). The reference gates this lane
     behind an opt-in switch and reaches its sort lane first;
  2. the single-word code sort (``sortgroup.sort_groupby``);
  3. the code sort with argmin/argmax (``fastgroup.fast_groupby``);
  4. the generic engine below: a stable lexicographic sort of row codes,
     then per-segment reductions — it also answers what the reference's
     wide lane answers (non-integral float keys).

Every lane returns groups in ascending key order with nulls last (pandas
sort=True). The reference's chunked branch is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..utils.padding import bucket_capacity
from . import fastgroup, rowcodes
from .copying import gather
from .sortprim import _posbits, multisort_perm, segment_reduce, tiled_cumsum


@dataclasses.dataclass(frozen=True)
class AggSpec:
    column: str          # input column name ("" for size)
    kind: str            # aggregation kind
    out_name: str
    param: float = 0.0   # quantile q / var ddof / nth n


def _onehot_plan(tbl: Table, keys: Sequence[str], aggs):
    """(plan, tbits) when the one-hot kernel lane applies, else None."""
    if not all(s.kind in fastgroup.ONEHOT_KINDS for s in aggs):
        return None
    vnames = {s.column for s in aggs if s.column}
    if len(vnames) > 1 or any(tbl[n].dtype.physical != torch.float32 for n in vnames):
        return None
    kcols = [tbl[k] for k in keys]
    plan = fastgroup.plan_codes(kcols, max_bits=62 - _posbits(kcols[0].capacity))
    if plan is None:
        return None
    tbits = sum(w for _, w in plan)
    return (plan, tbits) if tbits <= fastgroup.ONEHOT_MAX_BITS else None


def groupby_aggregate(tbl: Table, keys: Sequence[str], aggs: Sequence[AggSpec],
                      dropna_keys: bool = True) -> Table:
    """Grouped aggregation; output rows are in sorted key order."""
    from .sortgroup import sort_groupby

    aggs = tuple(aggs)
    onehot = _onehot_plan(tbl, keys, aggs)
    if onehot is not None:
        return fastgroup._onehot_groupby(tbl, keys, aggs, dropna_keys, *onehot)
    sg = sort_groupby(tbl, keys, aggs, dropna_keys)
    if sg is not None:
        return sg
    fast = fastgroup.fast_groupby(tbl, keys, aggs, dropna_keys)
    if fast is not None:
        return fast

    kcols = tuple(tbl[k] for k in keys)
    perm, seg, newgrp, inb_sorted, n_groups = _grouping(kcols, dropna_keys)
    out_cap = bucket_capacity(max(n_groups, 1))
    vcols = tuple(tbl[s.column] if s.column else kcols[0] for s in aggs)
    vperms = []
    for s in aggs:
        if s.kind in ("nunique", "median", "quantile"):
            vperms.append(multisort_perm(
                _value_sort_codes(kcols, tbl[s.column], s.kind != "nunique")))
        else:
            vperms.append(None)
    out = _aggregate_impl(kcols, vcols, tuple(keys), aggs, out_cap, perm, seg,
                          inb_sorted, n_groups, tuple(vperms))
    return Table({n: out[n] for n in list(keys) + [s.out_name for s in aggs]})


# ---------------------------------------------------------------------------
# generic engine
# ---------------------------------------------------------------------------

def _anynull(keys) -> torch.Tensor:
    out = torch.zeros(keys[0].capacity, dtype=torch.bool, device=keys[0].device)
    for k in keys:
        if k.validity is not None:
            out |= ~k.validity
    return out


def _grouping_codes(keys, dropna=False):
    ops = rowcodes.grouping_operands(keys, keys[0].length)
    if dropna and any(k.validity is not None for k in keys):
        # null-key rows sort after all valid rows (before padding): dropping
        # them is then just exclusion from the group count
        ops = [ops[0], _anynull(keys).to(torch.int64)] + list(ops[1:])
    return ops


def _grouping_finish(keys, perm, dropna=False):
    """Given the key-sorted permutation: (seg, newgrp, live_sorted, n_groups)."""
    length = keys[0].length
    cap = keys[0].capacity
    sorted_ops = [op[perm] for op in rowcodes.grouping_operands(keys, length)]
    newgrp = rowcodes.adjacent_neq(sorted_ops)
    live = torch.arange(cap, device=perm.device) < length  # padding sorts last
    if dropna and any(k.validity is not None for k in keys):
        live &= ~_anynull(keys)[perm]
    n_groups = int((newgrp & live).sum().item())
    seg = tiled_cumsum(newgrp) - 1
    return seg, newgrp, live, n_groups


def _grouping(keys, dropna=False):
    """Stable sort of rows by key; (perm, seg, newgrp, live_sorted, n_groups)."""
    perm = multisort_perm(_grouping_codes(keys, dropna))
    seg, newgrp, live, n_groups = _grouping_finish(keys, perm, dropna)
    return perm, seg, newgrp, live, n_groups


def _value_sort_codes(kcols, vcol, ordered):
    """Codes for a (keys..., value) sort: ordered=True keeps value order
    (quantile); ordered=False only needs value-equality runs (nunique)."""
    ops = rowcodes.grouping_operands(list(kcols), kcols[0].length)
    if ordered:
        return ops + rowcodes.sort_key_operands(vcol, False, True)
    return ops + rowcodes.equality_operands(vcol)


def _aggregate_impl(kcols, vcols, keynames, aggs, out_cap, perm, seg,
                    inb_sorted, n_groups, vperms) -> Dict[str, Column]:
    cap = kcols[0].capacity
    dev = perm.device
    nseg = out_cap + 1  # overflow bucket for padding rows
    pos = torch.arange(cap, device=dev)
    seg_c = torch.where(inb_sorted, seg.clamp(max=nseg - 1), nseg - 1)

    # unique key rows: first sorted position of each group
    first_pos = segment_reduce(torch.where(inb_sorted, pos, cap - 1), seg_c,
                               nseg, "amin", cap - 1)
    key_idx = perm[first_pos[:out_cap].clamp(0, cap - 1)]
    out: Dict[str, Column] = {}
    for kname, kc in zip(keynames, kcols):
        out[kname] = gather(kc, key_idx, n_groups)
    counts_all = segment_reduce(inb_sorted.to(torch.int64), seg_c, nseg,
                                "sum", 0)[:out_cap]
    for spec, vcol, vperm in zip(aggs, vcols, vperms):
        out[spec.out_name] = _compute_agg(vcol, spec, perm, seg_c, inb_sorted,
                                          nseg, out_cap, n_groups, counts_all,
                                          kcols, vperm)
    return out


def _compute_agg(vcol: Column, spec: AggSpec, perm, seg_c, inb_sorted,
                 nseg: int, out_cap: int, n_groups: int, counts_all, kcols,
                 vperm=None) -> Column:
    kind = spec.kind
    if kind == "size":
        return Column(dtypes.int64, counts_all, None, n_groups)

    sv = vcol.data[perm]
    svalid = inb_sorted
    if vcol.validity is not None:
        svalid = svalid & vcol.validity[perm]

    def seg_sum(x):
        return segment_reduce(x, seg_c, nseg, "sum", 0)[:out_cap]

    cnt = seg_sum(svalid.to(torch.int64))
    validity = cnt > 0  # most aggs: null when no valid values in group

    if kind == "count":
        return Column(dtypes.int64, cnt, None, n_groups)

    if kind in ("sum", "mean", "var", "std", "m2", "sum_of_squares"):
        acc = torch.float64 if vcol.dtype.is_floating else torch.int64
        if vcol.dtype.is_floating and vcol.dtype.bits <= 32:
            acc = torch.float32
        x = torch.where(svalid, fastgroup._as_acc(sv, acc),
                        torch.zeros((), dtype=acc, device=sv.device))
        s = seg_sum(x)
        if kind == "sum":
            return Column(fastgroup._dtype_of(s), s, validity, n_groups)
        if kind == "sum_of_squares":
            s2 = seg_sum(x * x)
            return Column(fastgroup._dtype_of(s2), s2, validity, n_groups)
        mean = s.to(torch.float64) / cnt.clamp(min=1)
        if kind == "mean":
            return Column(dtypes.float64, mean, validity, n_groups)
        # two-pass M2 for numerical stability (reference: group_m2.cu)
        centered = x.to(torch.float64) - fastgroup._at_group(mean, seg_c)
        m2 = seg_sum(torch.where(svalid, centered * centered, 0.0))
        if kind == "m2":
            return Column(dtypes.float64, m2, validity, n_groups)
        ddof = int(spec.param) if spec.param else 1
        denom = cnt - ddof
        var = torch.where(denom > 0, m2 / denom.clamp(min=1), float("nan"))
        validity = validity & (denom > 0)
        return Column(dtypes.float64, var if kind == "var" else torch.sqrt(var),
                      validity, n_groups)

    if kind == "product":
        acc = torch.float64 if vcol.dtype.is_floating else torch.int64
        x = torch.where(svalid, fastgroup._as_acc(sv, acc),
                        torch.ones((), dtype=acc, device=sv.device))
        p = segment_reduce(x, seg_c, nseg, "prod", 1)[:out_cap]
        return Column(fastgroup._dtype_of(p), p, validity, n_groups)

    if kind in ("min", "max", "argmin", "argmax"):
        for_min = kind in ("min", "argmin")
        r, back = fastgroup._reducible(sv)
        ident = fastgroup._ident(r.dtype, for_min)
        x = torch.where(svalid, r, torch.full((), ident, dtype=r.dtype, device=r.device))
        best = segment_reduce(x, seg_c, nseg, "amin" if for_min else "amax", ident)
        if kind in ("min", "max"):
            return Column(vcol.dtype, back(best[:out_cap]), validity, n_groups,
                          vcol.dictionary)
        cap = sv.shape[0]
        pos = torch.arange(cap, device=sv.device)
        isbest = svalid & (x == best[seg_c])
        bp = segment_reduce(torch.where(isbest, pos, cap - 1), seg_c, nseg,
                            "amin", cap - 1)[:out_cap].clamp(0, cap - 1)
        return Column(dtypes.int64, perm[bp], validity, n_groups)

    if kind in ("any", "all"):
        b = sv != 0
        if kind == "any":
            r = segment_reduce((svalid & b).to(torch.int32), seg_c, nseg, "amax", 0)
        else:
            r = segment_reduce((~svalid | b).to(torch.int32), seg_c, nseg, "amin", 1)
        return Column(dtypes.bool_, r[:out_cap].to(torch.bool), validity, n_groups)

    if kind in ("first", "last", "nth"):
        cap = sv.shape[0]
        pos = torch.arange(cap, device=sv.device)
        if kind in ("first", "nth"):
            fp = segment_reduce(torch.where(svalid, pos, cap - 1), seg_c, nseg,
                                "amin", cap - 1)[:out_cap]
            sp = (fp + int(spec.param)).clamp(0, cap - 1)
        else:
            sp = segment_reduce(torch.where(svalid, pos, 0), seg_c, nseg,
                                "amax", 0)[:out_cap].clamp(0, cap - 1)
        g = gather(vcol, perm[sp], n_groups)
        v = g.validity if g.validity is not None else torch.ones_like(validity)
        return Column(g.dtype, g.data, v & validity, n_groups, vcol.dictionary)

    if kind == "nunique":
        return _nunique(kcols, vcol, nseg, out_cap, n_groups, vperm)
    if kind in ("median", "quantile"):
        q = 0.5 if kind == "median" else float(spec.param)
        return _quantile(kcols, vcol, nseg, out_cap, n_groups, q, vperm)
    raise ValueError(f"unsupported aggregation {kind!r}")


def _sorted_segments(kcols, perm, nseg):
    """(sorted key operands, in-bounds mask, clamped segment ids) of rows
    sorted by ``perm``."""
    length = kcols[0].length
    cap = kcols[0].capacity
    ops = rowcodes.grouping_operands(list(kcols), length)
    key_sorted = [op[perm] for op in ops]
    seg = tiled_cumsum(rowcodes.adjacent_neq(key_sorted)) - 1
    inb = torch.arange(cap, device=perm.device) < length
    seg_c = torch.where(inb, seg.clamp(max=nseg - 1), nseg - 1)
    return key_sorted, inb, seg_c


def _nunique(kcols, vcol: Column, nseg, out_cap, n_groups, perm) -> Column:
    """Distinct valid values per group: sorted by (keys, value); count the
    runs holding at least one valid row."""
    key_sorted, inb, seg_c = _sorted_segments(kcols, perm, nseg)
    cap = vcol.capacity
    pos = torch.arange(cap, device=perm.device)
    vsorted = [op[perm] for op in rowcodes.equality_operands(vcol)]
    newval = rowcodes.adjacent_neq(key_sorted + vsorted)
    svalid = inb
    if vcol.validity is not None:
        svalid = svalid & vcol.validity[perm]
    runid = tiled_cumsum(newval) - 1
    first_valid = segment_reduce(torch.where(svalid, pos, cap - 1), runid, cap,
                                 "amin", cap - 1)
    isfirst = svalid & (first_valid[runid] == pos)
    r = segment_reduce(isfirst.to(torch.int64), seg_c, nseg, "sum", 0)[:out_cap]
    return Column(dtypes.int64, r, None, n_groups)


def _quantile(kcols, vcol: Column, nseg, out_cap, n_groups, q: float, perm) -> Column:
    """Per-group linear-interpolation quantile via a (keys, value) sort."""
    _, inb, seg_c = _sorted_segments(kcols, perm, nseg)
    cap = vcol.capacity
    pos = torch.arange(cap, device=perm.device)
    svalid = inb
    if vcol.validity is not None:
        svalid = svalid & vcol.validity[perm]
    sv = vcol.data[perm]
    if vcol.dtype.is_floating:
        svalid = svalid & ~torch.isnan(sv)
    sv = sv.to(torch.float64)
    cnt = segment_reduce(svalid.to(torch.int64), seg_c, nseg, "sum", 0)
    start = segment_reduce(torch.where(inb, pos, cap - 1), seg_c, nseg, "amin", cap - 1)
    # valid values sort first within the group (nulls last)
    k = q * (cnt.to(torch.float64) - 1.0)
    lo = torch.floor(k).to(torch.int64)
    hi = torch.ceil(k).to(torch.int64)
    frac = k - lo.to(torch.float64)
    vlo = sv[(start + lo).clamp(0, cap - 1)]
    vhi = sv[(start + hi).clamp(0, cap - 1)]
    r = (vlo * (1 - frac) + vhi * frac)[:out_cap]
    return Column(dtypes.float64, r, (cnt > 0)[:out_cap], n_groups)
