"""Code-sort groupby and the one-hot kernel lane.

Counterpart of ``cudf_tpu/ops/fastgroup.py``:

  1. each key column reduces to a small integer code monotone in sort order
     (code = value - min, NaN and null codes above the range), sized from
     cached column stats (core/stats.py);
  2. codes pack lexicographically into one int64 slot; a stable sort by the
     slot makes groups contiguous and in key order (pandas sort=True);
  3. sums and counts are per-group sums over the sorted rows
     (``GroupSums``); min/max and the other order statistics are per-group
     reductions.

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

# GroupSums plans: pieces of <= _PIECE rows for groups of _LARGE rows or
# more on average, else blocks of _BLOCK rows (log2(_BLOCK) scan steps).
# The plans were timed at the two ends (9.8M groups of ~1.6 rows, six of
# ~10M rows); _LARGE between them was not measured at its crossover.
_PIECE = 1024
_LARGE = 256
_BLOCK = 16
_STEPS = tuple(1 << i for i in range(_BLOCK.bit_length() - 1))
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
    # floats accumulate in f64; results cast back per group
    return torch.float64 if sv.is_floating_point() else torch.int64


class GroupSums:
    """Per-group sums of key-sorted rows, built once for a grouping and
    applied to each value column. The groups are contiguous from row 0,
    ``lengths`` rows each (``n_rows`` in all), ``seg`` holds each row's
    group id, and rows past ``n_rows`` are ignored.

    A float group adds only its own rows, in a fixed order, in one of two
    plans chosen from the group sizes:

      * groups of ``_LARGE`` rows or more on average (q1's six groups of
        60M rows): each group is cut at every ``_PIECE``-th row of the
        table, ``segment_reduce`` sums the pieces, then each group's
        pieces;
      * smaller groups (a groupby on order keys): rows are cut into blocks
        of ``_BLOCK``, a segmented scan of log2(_BLOCK) steps sums each
        group's piece of each block (a step adds a row's partner only when
        both lie in one group), and a group that spans blocks adds its
        pieces with ``segment_reduce``; one launch a group would cost
        more than the scan.

    Either way the same input gives the same bits on every run, and a
    group adds only its own rows: a term of a group of m rows goes through
    at most m - 1 additions, so the error is within (m - 1)·eps·Σ_group|x|
    whatever the plan, never a prefix over the table. The depth is far
    less in the blocks plan (log2(_BLOCK) scan steps, then its pieces), but
    ``segment_reduce`` adds a thread's items one after another, so the
    pieces plan (up to _PIECE - 1 within a piece, then the group's pieces:
    ~58k for q1) keeps no bound of log2 depth. An integer group is exact
    as a difference of prefix sums."""

    def __init__(self, seg: torch.Tensor, lengths: torch.Tensor, n_rows: int):
        self.seg, self.lengths, self.n_rows = seg, lengths, n_rows
        self._plan = None

    def _pieces_plan(self):
        n, dev = self.n_rows, self.seg.device
        starts = torch.cumsum(self.lengths, 0) - self.lengths
        cuts = torch.unique(torch.cat([starts, torch.arange(0, n, _PIECE, device=dev)]))
        owner = torch.searchsorted(starts, cuts, right=True) - 1
        return ("pieces", torch.diff(cuts, append=cuts.new_full((1,), n)),
                torch.bincount(owner, minlength=self.lengths.numel()))

    def _blocks_plan(self):
        n, B = self.n_rows, _BLOCK
        nb = -(-n // B)
        ss = torch.nn.functional.pad(self.seg[:n], (0, nb * B - n), value=-1).view(nb, B)
        same = [ss[:, d:] == ss[:, :-d] for d in _STEPS]
        last = torch.ones_like(ss, dtype=torch.bool)
        last[:, :-1] = ss[:, 1:] != ss[:, :-1]
        ends = torch.nonzero((last & (ss >= 0)).reshape(-1)).squeeze(1)
        pseg = ss.reshape(-1)[ends]
        npieces = torch.bincount(pseg, minlength=self.lengths.numel())
        single = npieces[pseg] == 1
        one_src = torch.nonzero(single).squeeze(1)
        multi_grp = torch.nonzero(npieces > 1).squeeze(1)
        return ("blocks", nb, same, ends, one_src, pseg[one_src],
                torch.nonzero(~single).squeeze(1), multi_grp, npieces[multi_grp])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n_groups, n = self.lengths.numel(), self.n_rows
        if n_groups == 0:
            return x.new_zeros(0)
        if not x.is_floating_point():
            hi = tiled_cumsum(x[:n])[torch.cumsum(self.lengths, 0) - 1]
            return hi - torch.cat([hi.new_zeros(1), hi[:-1]])
        if self._plan is None:
            self._plan = (self._pieces_plan() if n >= _LARGE * n_groups
                          else self._blocks_plan())
        if self._plan[0] == "pieces":
            _, piece_len, per_group = self._plan
            pieces = torch.segment_reduce(x[:n], "sum", lengths=piece_len)
            return torch.segment_reduce(pieces, "sum", lengths=per_group)
        _, nb, same, ends, one_src, one_dst, multi_src, multi_grp, multi_len = self._plan
        xs = x.new_zeros(nb * _BLOCK)
        xs[:n] = x[:n]  # a copy: the scan below runs in place
        xs = xs.view(nb, _BLOCK)
        for d, m in zip(_STEPS, same):
            xs[:, d:] += torch.where(m, xs[:, :-d], 0.0)
        pieces = xs.reshape(-1)[ends]
        out = x.new_zeros(n_groups)
        out[one_dst] = pieces[one_src]
        if multi_grp.numel():
            out[multi_grp] = torch.segment_reduce(pieces[multi_src], "sum",
                                                  lengths=multi_len)
        return out


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


def build_scan_arrays(sv, svalid, act, seg, n_groups, sums: GroupSums,
                      kset) -> Dict[str, torch.Tensor]:
    """Per-group arrays (length n_groups) of one value column over
    KEY-SORTED rows, active rows first: ``g_*`` are sums (``sums``, the
    grouping's GroupSums), the rest per-group reductions; ``sv`` and
    ``valid`` are the sorted rows. ``seg`` is each row's group id,
    ``n_groups`` for inactive rows (an overflow segment)."""
    valid = act if svalid is None else act & svalid
    nseg = n_groups + 1
    rowpos = torch.arange(sv.shape[0], device=sv.device)
    arrs: Dict[str, torch.Tensor] = {"sv": sv, "valid": valid}
    arrs["g_cnt"] = sums(valid.to(torch.int64))
    if kset & {"sum", "mean", "var", "std", "m2", "sum_of_squares"}:
        acc = _acc_dtype_from(sv)
        x = torch.where(valid, _as_acc(sv, acc), torch.zeros((), dtype=acc,
                                                              device=sv.device))
        arrs["g_sum"] = sums(x)
        if "sum_of_squares" in kset:
            arrs["g_sos"] = sums(x * x)
        if kset & {"var", "std", "m2"}:
            # two-pass M2 (reference: group_m2.cu): center by the group mean
            mean = arrs["g_sum"].to(torch.float64) / arrs["g_cnt"].clamp(min=1)
            c = torch.where(valid, sv.to(torch.float64) - _at_group(mean, seg), 0.0)
            arrs["g_m2"] = sums(c * c)
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


def group_starts(newgrp: torch.Tensor, n_active: int):
    """(starts, lengths): each group's first sorted row and its row count,
    in key order."""
    starts = torch.nonzero(newgrp).squeeze(1)
    return starts, torch.diff(starts, append=starts.new_full((1,), n_active))


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
    starts, lengths = group_starts(newgrp, n_active)
    sums = GroupSums(seg, lengths, n_active)

    vcols, kinds, agg_vidx = _value_columns(tbl, keys, aggs)
    arrs_by_col = []
    for c, kset in zip(vcols, kinds):
        sval = c.validity[pos] if c.validity is not None else None
        arrs_by_col.append(build_scan_arrays(c.data[pos], sval, act, seg, n_groups,
                                             sums, kset))

    out = decode_keys(keys, kcols, plan, scode[starts], n_groups)
    for spec, vidx in zip(aggs, agg_vidx):
        out[spec.out_name] = _finish_agg(spec, arrs_by_col[vidx], vcols[vidx],
                                         lengths, seg, pos, n_groups)
    return Table({n: out[n] for n in list(keys) + [s.out_name for s in aggs]})


def _finish_agg(spec, arrs, vcol, lengths, seg, pos, n_groups) -> Column:
    kind = spec.kind
    cnt = arrs["g_cnt"]
    validity = cnt > 0

    def col(dt, data, v=validity, dictionary=None):
        return padded_column(dt, data, v, n_groups, dictionary)

    if kind == "size":
        return col(dtypes.int64, lengths, None)
    if kind == "count":
        return col(dtypes.int64, cnt, None)

    if kind == "sum_of_squares":
        return col(_dtype_of(arrs["g_sos"]), arrs["g_sos"])
    if kind == "sum":
        s = arrs["g_sum"]
        if vcol.dtype.is_floating and vcol.dtype.bits <= 32:
            return col(dtypes.float32, s.to(torch.float32))
        return col(_dtype_of(s), s)
    if kind == "mean":
        return col(dtypes.float64, arrs["g_sum"].to(torch.float64) / cnt.clamp(min=1))
    if kind in ("var", "std", "m2"):
        m2 = arrs["g_m2"]
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
    value sum and counts; the occupied slots, in slot order (= key order),
    become the groups. A value column with nulls goes in as two columns,
    ``where(valid, v, 0)`` and ``valid``, so the kernel returns the valid
    sum, the valid count and the row count (V = 2; ``where``, as a product
    would keep a NaN under a null); one without nulls as itself (V = 1),
    its count being the row count. The key mask is the weight. Counts
    come back exact from f64."""
    from ..kernels.onehot_groupby import groupby_sum_count

    kcols = [tbl[k] for k in keys]
    T = 1 << tbits
    slot, active = _make_key(kcols, plan, dropna_keys)
    gid = torch.where(active, slot.clamp(0, T - 1), -1).to(torch.int32)
    vname = next((s.column for s in aggs if s.column), None)
    vcol = tbl[vname] if vname is not None else None
    if vcol is None:
        vals = torch.zeros((kcols[0].capacity, 1), dtype=torch.float32, device=slot.device)
    elif vcol.validity is None:
        vals = vcol.data[:, None]
    else:
        vals = torch.stack([torch.where(vcol.validity, vcol.data, 0.0),
                            vcol.validity.to(torch.float32)], 1)
    out = groupby_sum_count(gid, vals, active.to(torch.float32), T)
    grp_slot = torch.nonzero(out[:, -1] > 0.5).squeeze(1)
    n_groups = grp_slot.shape[0]
    g = out[grp_slot]
    sums, size = g[:, 0], g[:, -1]
    cnt = g[:, 1] if vals.shape[1] == 2 else size
    validity = cnt > 0.5 if vals.shape[1] == 2 else None

    cols = decode_keys(keys, kcols, plan, grp_slot, n_groups)
    for spec in aggs:
        v = validity
        if spec.kind == "sum":
            data, dt = sums.to(torch.float32), dtypes.float32
        elif spec.kind == "mean":
            data, dt = sums / cnt.clamp(min=1.0), dtypes.float64
        else:
            data, dt, v = (cnt if spec.kind == "count" else size).to(torch.int64), \
                dtypes.int64, None
        cols[spec.out_name] = padded_column(dt, data, v, n_groups)
    return Table({n: cols[n] for n in list(keys) + [s.out_name for s in aggs]})
