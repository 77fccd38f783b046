"""Code-sort groupby and the one-hot kernel lane.

Counterpart of ``cudf_tpu/ops/fastgroup.py``:

  1. each key column reduces to a small integer code monotone in sort order
     (code = value - min, NaN and null codes above the range), sized from
     cached column stats (core/stats.py);
  2. codes pack lexicographically into one int64 slot; a stable sort by the
     slot makes groups contiguous and in key order (pandas sort=True);
  3. sums and counts are prefix sums read at group boundaries; min/max and
     the other order statistics are per-group reductions.

``_onehot_groupby`` (the reference's ``_pallas_onehot_groupby``) sends
<= 2048-slot keys with f32 sum/mean/count/size to the hand-written kernel
(kernels/onehot_groupby.py) instead of sorting.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtypes
from ..core import stats as colstats
from ..core.column import Column
from ..core.dtypes import Kind
from ..core.table import Table
from ..utils.padding import bucket_capacity
from .sortprim import _posbits, segment_reduce, tiled_cumsum

_SUPPORTED = {
    "sum", "product", "min", "max", "count", "size", "any", "all", "mean",
    "var", "std", "m2", "sum_of_squares", "first", "last", "argmin",
    "argmax", "nth",
}
ONEHOT_KINDS = {"sum", "mean", "count", "size"}
ONEHOT_MAX_BITS = 11  # 2^11 = 2048 slots: kernels/onehot_groupby.MAX_GROUPS

_I32MAX = int(np.iinfo(np.int32).max)
_I64_MIN = -(1 << 63)


def plan_codes(kcols: Sequence[Column], max_bits: int):
    """Per-key (stats, width) when every key is integral-codeable and the
    packed width fits; else None."""
    plan = []
    total = 0
    for c in kcols:
        st = colstats.compute_stats(c)
        if st is None:
            return None
        w = st.code_width()
        if w is None:
            return None
        plan.append((st, w))
        total += w
    if total > max_bits:
        return None
    return plan


def _vmin_signed(c: Column, st: colstats.ColStats) -> int:
    """vmin in the domain of ``colstats.as_int64(c)`` (exact Python int)."""
    return int(st.vmin) + (_I64_MIN if c.data.dtype == torch.uint64 else 0)


def _key_code(c: Column, st: colstats.ColStats, w: int) -> torch.Tensor:
    """int64 code of one key: value - vmin, then the NaN and null codes.
    Non-float keys subtract in int64, exact at any magnitude."""
    rng = st.value_range
    if c.dtype.kind == Kind.FLOAT:
        code = (c.data.to(torch.float64) - st.vmin).to(torch.int64)
        if st.has_nan:
            code = torch.where(torch.isnan(c.data), rng, code)
    else:
        code = colstats.as_int64(c) - _vmin_signed(c, st)
    if c.validity is not None:
        code = torch.where(c.validity, code, rng + (1 if st.has_nan else 0))
    return code.clamp(0, (1 << w) - 1)


def _make_key(kcols: Sequence[Column], plan, dropna: bool):
    """(slot int64, active bool): packed key codes, first key most
    significant; ``active`` marks in-bounds rows (minus null keys when
    ``dropna``). Inactive rows hold garbage codes; callers mask them."""
    cap = kcols[0].capacity
    slot = torch.zeros(cap, dtype=torch.int64, device=kcols[0].device)
    active = kcols[0].bounds_mask()
    for c, (st, w) in zip(kcols, plan):
        slot = (slot << w) | _key_code(c, st, w)
        if dropna and c.validity is not None:
            active = active & c.validity
    return slot, active


def decode_key(c: Column, st: colstats.ColStats, code: torch.Tensor):
    """Inverse of ``_key_code``: (data, validity or None) in c's dtype."""
    rng = st.value_range
    phys = c.dtype.physical
    if c.dtype.kind == Kind.FLOAT:
        data = (code.to(torch.float64) + st.vmin).to(phys)
        if st.has_nan:
            data = torch.where(code == rng, float("nan"), data)
    else:
        v = code + _vmin_signed(c, st)
        data = (v ^ _I64_MIN).view(phys) if phys == torch.uint64 else v.to(phys)
    validity = None
    if c.validity is not None:
        validity = code != rng + (1 if st.has_nan else 0)
        data = torch.where(validity, data, torch.zeros((), dtype=phys,
                                                        device=data.device))
    return data, validity


def decode_keys(keys: Sequence[str], kcols: Sequence[Column], plan,
                word: torch.Tensor, n_groups: int) -> Dict[str, Column]:
    """Output key columns from each group's packed word (first key most
    significant, ``plan`` as from plan_codes / plan_wide)."""
    out: Dict[str, Column] = {}
    shift = sum(w for _, w in plan)
    for name, c, (st, w) in zip(keys, kcols, plan):
        shift -= w
        data, validity = decode_key(c, st, (word >> shift) & ((1 << w) - 1))
        out[name] = padded_column(c.dtype, data, validity, n_groups, c.dictionary)
    return out


def padded_column(dtype, data: torch.Tensor, validity: Optional[torch.Tensor],
                  n: int, dictionary=None) -> Column:
    """Column of ``n`` rows from length-n tensors, padded to its bucket."""
    cap = bucket_capacity(n)
    d = torch.zeros(cap, dtype=data.dtype, device=data.device)
    d[:n] = data[:n]
    v = None
    if validity is not None:
        v = torch.zeros(cap, dtype=torch.bool, device=data.device)
        v[:n] = validity[:n]
    return Column(dtype, d, v, n, dictionary)


def _acc_dtype_from(sv: torch.Tensor) -> torch.dtype:
    # floats always accumulate in f64: a prefix-sum difference amplifies
    # rounding by the PREFIX magnitude; results cast back per group
    return torch.float64 if sv.is_floating_point() else torch.int64


def _reducible(sv: torch.Tensor):
    """(values in a dtype scatter_reduce orders, inverse) — torch reduces no
    bool or unsigned >8-bit type; uint64 goes through the signed domain."""
    if sv.dtype == torch.bool:
        return sv.to(torch.int8), lambda r: r.to(torch.bool)
    if sv.dtype == torch.uint64:
        return (sv.view(torch.int64) ^ _I64_MIN,
                lambda r: (r ^ _I64_MIN).view(torch.uint64))
    if sv.dtype in (torch.uint16, torch.uint32):
        dt = sv.dtype
        return sv.to(torch.int64), lambda r: r.to(dt)
    return sv, lambda r: r


def _ident(dt: torch.dtype, for_min: bool):
    if dt.is_floating_point:
        return float("inf") if for_min else float("-inf")
    info = torch.iinfo(dt)
    return info.max if for_min else info.min


def _as_acc(sv: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    if sv.dtype == torch.uint64:
        return sv.view(torch.int64)  # wraps, as the reference's astype
    return sv.to(acc)


def build_scan_arrays(sv, svalid, act, newgrp, seg, n_groups, kset) -> Dict[str, torch.Tensor]:
    """Per-value-column arrays over KEY-SORTED rows: ``cs_*`` are prefix
    scans read at group boundaries, the rest are per-group reductions
    (length n_groups). ``seg`` is each row's group id, ``n_groups`` for
    inactive rows (an overflow segment)."""
    valid = act if svalid is None else act & svalid
    nseg = n_groups + 1
    rowpos = torch.arange(sv.shape[0], device=sv.device)
    arrs: Dict[str, torch.Tensor] = {"sv": sv, "valid": valid}
    arrs["cs_cnt"] = tiled_cumsum(valid)
    if kset & {"sum", "mean", "var", "std", "m2", "sum_of_squares"}:
        acc = _acc_dtype_from(sv)
        x = torch.where(valid, _as_acc(sv, acc), torch.zeros((), dtype=acc,
                                                              device=sv.device))
        arrs["cs_sum"] = tiled_cumsum(x)
        if "sum_of_squares" in kset:
            arrs["cs_sos"] = tiled_cumsum(x * x)
    if "varc" in kset:  # sentinel kind added by ops/sortgroup.py
        # single-pass var for the compaction lane: scans of x-K and (x-K)^2
        # with K = the GLOBAL mean (group variance is shift-invariant, and
        # centering kills most of the sum-of-squares cancellation)
        xf = torch.where(valid, sv.to(torch.float64), 0.0)
        nv = valid.sum().clamp(min=1)
        K = xf.sum() / nv
        xc = torch.where(valid, xf - K, 0.0)
        arrs["cs_sumc"] = tiled_cumsum(xc)
        arrs["cs_sosc"] = tiled_cumsum(xc * xc)
    if "product" in kset:
        acc = _acc_dtype_from(sv)
        x = torch.where(valid, _as_acc(sv, acc), torch.ones((), dtype=acc,
                                                             device=sv.device))
        arrs["prod"] = segment_reduce(x, seg, nseg, "prod", 1)[:n_groups]
    if kset & {"min", "argmin", "max", "argmax"}:
        r, back = _reducible(sv)
        for name, for_min in (("smin", True), ("smax", False)):
            if kset & ({"min", "argmin"} if for_min else {"max", "argmax"}):
                ident = _ident(r.dtype, for_min)
                x = torch.where(valid, r, torch.full((), ident, dtype=r.dtype,
                                                     device=r.device))
                red = segment_reduce(x, seg, nseg, "amin" if for_min else "amax",
                                     ident)[:n_groups]
                arrs[name] = back(red)
    if "any" in kset:
        # truthiness, not integer truncation: 0.5 is truthy
        x = (valid & (sv != 0)).to(torch.int32)
        arrs["sany"] = segment_reduce(x, seg, nseg, "amax", 0)[:n_groups]
    if "all" in kset:
        x = (~valid | (sv != 0)).to(torch.int32)
        arrs["sall"] = segment_reduce(x, seg, nseg, "amin", 1)[:n_groups]
    if kset & {"first", "nth"}:
        x = torch.where(valid, rowpos, _I32MAX)
        arrs["sfirst"] = segment_reduce(x, seg, nseg, "amin", _I32MAX)[:n_groups]
    if "last" in kset:
        x = torch.where(valid, rowpos, -1)
        arrs["slast"] = segment_reduce(x, seg, nseg, "amax", -1)[:n_groups]
    return arrs


def _boundaries(newgrp: torch.Tensor, n_active: int):
    """Per-group (start, end) sorted-row indices, in key order."""
    starts = torch.nonzero(newgrp).squeeze(1)
    ends = torch.cat([starts[1:] - 1,
                      torch.full((1,), n_active - 1, device=starts.device)])
    return starts, ends[: starts.shape[0]]


def _diff_at(cs, starts, ends):
    lo = torch.where(starts > 0, cs[(starts - 1).clamp(min=0)],
                     torch.zeros((), dtype=cs.dtype, device=cs.device))
    return cs[ends] - lo


def _value_columns(tbl: Table, keys, aggs):
    """Deduplicated value columns and the agg kinds asked of each."""
    vmap: Dict[str, int] = {}
    vcols: List[Column] = []
    kinds: List[set] = []
    for s in aggs:
        cname = s.column if s.column else keys[0]
        if cname not in vmap:
            vmap[cname] = len(vcols)
            vcols.append(tbl[cname])
            kinds.append(set())
        kinds[vmap[cname]].add(s.kind)
    agg_vidx = [vmap[s.column if s.column else keys[0]] for s in aggs]
    return vcols, kinds, agg_vidx


def _group_ids(skey: torch.Tensor, act: torch.Tensor):
    """(newgrp, seg, n_groups, n_active) over key-sorted words, active rows
    first; ``seg`` sends inactive rows to the overflow segment n_groups."""
    newgrp = torch.ones_like(act)
    newgrp[1:] = skey[1:] != skey[:-1]
    newgrp &= act
    n_groups, n_active = torch.stack([newgrp.sum(), act.sum()]).tolist()
    seg = torch.where(act, tiled_cumsum(newgrp) - 1, n_groups)
    return newgrp, seg, n_groups, n_active


def _at_group(arr: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """arr[seg] for per-group ``arr``; the overflow segment reads 0."""
    return torch.cat([arr, arr.new_zeros(1)])[seg]


def fast_groupby(tbl: Table, keys: Sequence[str], aggs, dropna_keys: bool) -> Optional[Table]:
    """Code-sort groupby; None when this plan doesn't apply."""
    if not all(s.kind in _SUPPORTED for s in aggs):
        return None
    kcols = [tbl[k] for k in keys]
    cap = kcols[0].capacity
    plan = plan_codes(kcols, max_bits=62 - _posbits(cap))
    if plan is None:
        return None
    tbits = sum(w for _, w in plan)
    slot, active = _make_key(kcols, plan, dropna_keys)
    sentinel = 1 << tbits
    scode, pos = torch.sort(torch.where(active, slot, sentinel), stable=True)
    act = scode < sentinel
    newgrp, seg, n_groups, n_active = _group_ids(scode, act)

    vcols, kinds, agg_vidx = _value_columns(tbl, keys, aggs)
    arrs_by_col = []
    for c, kset in zip(vcols, kinds):
        sval = c.validity[pos] if c.validity is not None else None
        arrs_by_col.append(build_scan_arrays(c.data[pos], sval, act, newgrp,
                                             seg, n_groups, kset))
    starts, ends = _boundaries(newgrp, n_active)

    out = decode_keys(keys, kcols, plan, scode[starts], n_groups)
    for spec, vidx in zip(aggs, agg_vidx):
        out[spec.out_name] = _finish_agg(spec, arrs_by_col[vidx], vcols[vidx],
                                         starts, ends, seg, pos, n_groups)
    return Table({n: out[n] for n in list(keys) + [s.out_name for s in aggs]})


def _finish_agg(spec, arrs, vcol, starts, ends, seg, pos, n_groups) -> Column:
    kind = spec.kind
    cnt = _diff_at(arrs["cs_cnt"], starts, ends)
    validity = cnt > 0

    def col(dt, data, v=validity, dictionary=None):
        return padded_column(dt, data, v, n_groups, dictionary)

    if kind == "size":
        return col(dtypes.int64, ends - starts + 1, None)
    if kind == "count":
        return col(dtypes.int64, cnt, None)

    if kind in ("sum", "mean", "var", "std", "m2", "sum_of_squares"):
        if kind == "sum_of_squares":
            s2 = _diff_at(arrs["cs_sos"], starts, ends)
            return col(_dtype_of(s2), s2)
        s = _diff_at(arrs["cs_sum"], starts, ends)
        if kind == "sum":
            if vcol.dtype.is_floating and vcol.dtype.bits <= 32:
                return col(dtypes.float32, s.to(torch.float32))
            return col(_dtype_of(s), s)
        mean = s.to(torch.float64) / cnt.clamp(min=1)
        if kind == "mean":
            return col(dtypes.float64, mean)
        # two-pass M2 (reference: group_m2.cu): center by the group mean
        centered = arrs["sv"].to(torch.float64) - _at_group(mean, seg)
        x = torch.where(arrs["valid"], centered * centered, 0.0)
        m2 = _diff_at(tiled_cumsum(x), starts, ends)
        if kind == "m2":
            return col(dtypes.float64, m2)
        ddof = int(spec.param) if spec.param else 1
        denom = cnt - ddof
        var = torch.where(denom > 0, m2 / denom.clamp(min=1), float("nan"))
        v = validity & (denom > 0)
        return col(dtypes.float64, var if kind == "var" else torch.sqrt(var), v)

    if kind == "product":
        return col(_dtype_of(arrs["prod"]), arrs["prod"])
    if kind in ("min", "max"):
        return col(vcol.dtype, arrs["smin" if kind == "min" else "smax"],
                   dictionary=vcol.dictionary)
    if kind in ("any", "all"):
        return col(dtypes.bool_, arrs["sany" if kind == "any" else "sall"].to(torch.bool))

    cap = arrs["sv"].shape[0]
    if kind in ("first", "nth", "last"):
        if kind == "last":
            idx = arrs["slast"].clamp(0, cap - 1)
        else:
            idx = arrs["sfirst"].clamp(0, cap - 1)
            if kind == "nth":
                idx = (idx + int(spec.param)).clamp(0, cap - 1)
        return col(vcol.dtype, arrs["sv"][idx], dictionary=vcol.dictionary)

    if kind in ("argmin", "argmax"):
        best = arrs["smin" if kind == "argmin" else "smax"]
        isbest = arrs["valid"] & (arrs["sv"] == _at_group(best, seg))
        cand = torch.where(isbest, pos, _I32MAX)
        r = segment_reduce(cand, seg, n_groups + 1, "amin", _I32MAX)[:n_groups]
        return col(dtypes.int64, r)

    raise ValueError(f"unsupported fast agg {kind!r}")


def _dtype_of(t: torch.Tensor):
    return dtypes.from_numpy(np.dtype(str(t.dtype).replace("torch.", "")))


def _onehot_groupby(tbl: Table, keys: Sequence[str], aggs, dropna_keys: bool,
                    plan, tbits: int) -> Table:
    """One kernel pass (kernels/onehot_groupby.py) computes every slot's
    weighted value sum and count; the occupied slots, in slot order (= key
    order), become the groups. Counts come back exact from f64."""
    from ..kernels.onehot_groupby import groupby_sum_count

    kcols = [tbl[k] for k in keys]
    T = 1 << tbits
    slot, active = _make_key(kcols, plan, dropna_keys)
    gid = torch.where(active, slot.clamp(0, T - 1), -1).to(torch.int32)
    vname = next((s.column for s in aggs if s.column), None)
    cap = kcols[0].capacity
    vals = (tbl[vname].data if vname is not None
            else torch.zeros(cap, dtype=torch.float32, device=slot.device))
    out = groupby_sum_count(gid, vals[:, None], active.to(torch.float32), T)
    grp_slot = torch.nonzero(out[:, 1] > 0.5).squeeze(1)
    n_groups = grp_slot.shape[0]
    sums = out[grp_slot, 0]
    cnt = out[grp_slot, 1]

    cols = decode_keys(keys, kcols, plan, grp_slot, n_groups)
    for spec in aggs:
        if spec.kind == "sum":
            data, dt = sums.to(torch.float32), dtypes.float32
        elif spec.kind == "mean":
            data, dt = sums / cnt.clamp(min=1.0), dtypes.float64
        else:  # count, size
            data, dt = cnt.to(torch.int64), dtypes.int64
        cols[spec.out_name] = padded_column(dt, data, None, n_groups)
    return Table({n: cols[n] for n in list(keys) + [s.out_name for s in aggs]})
