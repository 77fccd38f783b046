"""Per-column statistics cache (counterpart of ``cudf_tpu/core/stats.py``).

Groupby lanes size their key codes from (min, max, integrality, NaN/null
presence). Columns are not mutated after construction, so the stats are
computed once (one host read) and memoized on the Column. A column derived
by compaction carries ``stats_ref``: its values are a subset of the
source's, so the source's stats bound it, and they are computed on the
source. A key that had nulls before ``drop_nulls`` therefore keeps
``has_null=True`` and its code width keeps the null code, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .column import Column
from .dtypes import Kind


@dataclasses.dataclass(frozen=True)
class ColStats:
    vmin: float          # min over valid, non-NaN rows (0 if none)
    vmax: float          # max over valid, non-NaN rows
    integral: bool       # every valid non-NaN value is an exact integer
    has_nan: bool        # any valid NaN value (floats)
    has_null: bool       # any in-bounds null row
    n_valid: int         # count of valid, non-NaN rows

    @property
    def value_range(self) -> int:
        """Number of distinct integer codes vmin..vmax (if integral)."""
        if not self.integral or self.n_valid == 0:
            return 0
        return int(self.vmax) - int(self.vmin) + 1

    def code_width(self) -> Optional[int]:
        """Bits for (value - vmin) codes + NaN/null codes, or None when the
        column is not integral-codeable within 2^40 codes. Codes are monotone
        in sort order with NaN > max value and null > NaN."""
        return self._code_width(1 << 40)

    def code_width_wide(self) -> Optional[int]:
        """Like code_width but admits ranges up to 2^62 (single-word sort
        lanes); exact only for exact (Python int) bounds."""
        return self._code_width(1 << 62)

    def _code_width(self, cap: int) -> Optional[int]:
        if not self.integral:
            return None
        r = self.value_range + (1 if self.has_nan else 0) + (1 if self.has_null else 0)
        r = max(r, 1)
        if r > cap:
            return None
        return max(1, int(r - 1).bit_length() if r > 1 else 1)


_STATS_KINDS = (Kind.BOOL, Kind.INT, Kind.UINT, Kind.FLOAT, Kind.TIMESTAMP,
                Kind.DURATION, Kind.DECIMAL)
# decimal64 too, so that a decimal key takes the lanes an int64 key takes
_EXACT64_KINDS = (Kind.INT, Kind.UINT, Kind.TIMESTAMP, Kind.DURATION, Kind.DECIMAL)
_I64_MIN = -(1 << 63)


def _is_exact64(col: Column) -> bool:
    """64-bit integer families keep exact (Python int) bounds: f64 stats
    would round past 2^53 and corrupt single-word key codes."""
    return col.dtype.kind in _EXACT64_KINDS and col.dtype.bits == 64


def as_int64(col: Column) -> torch.Tensor:
    """Integer-family data as int64, order-preserving; uint64 is flipped into
    signed order (x ^ INT64_MIN), since torch orders no unsigned 64-bit type."""
    d = col.data
    if d.dtype == torch.uint64:
        return d.view(torch.int64) ^ _I64_MIN
    return d.to(torch.int64)


def _exact_row(col: Column) -> torch.Tensor:
    """int64 [vmin, vmax, n_valid, has_null] of an exact-64 column."""
    inb = col.bounds_mask()
    ok = inb if col.validity is None else inb & col.validity
    d = as_int64(col)
    info = torch.iinfo(torch.int64)
    return torch.stack([torch.where(ok, d, info.max).min(),
                        torch.where(ok, d, info.min).max(),
                        ok.sum(), (inb & ~ok).any().to(torch.int64)])


def _exact_stats(col: Column, vals) -> ColStats:
    vmin, vmax, n_valid, has_null = vals
    if col.dtype.kind == Kind.UINT:
        vmin, vmax = vmin - _I64_MIN, vmax - _I64_MIN
    if n_valid == 0:
        return ColStats(0, 0, True, False, bool(has_null), 0)
    return ColStats(int(vmin), int(vmax), True, False, bool(has_null), int(n_valid))


def _float_row(col: Column) -> torch.Tensor:
    """f64 [vmin, vmax, n_valid, nonint, anynan, has_null] of a column."""
    inb = col.bounds_mask()
    ok = inb if col.validity is None else inb & col.validity
    d = col.data.to(torch.float64)
    isnan = torch.isnan(d) if col.dtype.kind == Kind.FLOAT else torch.zeros_like(ok)
    okv = ok & ~isnan
    inf = float("inf")
    return torch.stack([
        torch.where(okv, d, inf).min(), torch.where(okv, d, -inf).max(),
        okv.sum().to(torch.float64),
        (okv & (torch.floor(d) != d)).any().to(torch.float64),
        (ok & isnan).any().to(torch.float64),
        (inb & ~ok).any().to(torch.float64)])


def _float_stats(vals) -> ColStats:
    vmin, vmax, n_valid, nonint, anynan, has_null = vals
    n_valid = int(n_valid)
    if n_valid == 0:
        return ColStats(0.0, 0.0, True, bool(anynan), bool(has_null), 0)
    integral = (not bool(nonint)) and abs(vmin) < 2**52 and abs(vmax) < 2**52
    return ColStats(vmin, vmax, integral, bool(anynan), bool(has_null), n_valid)


def compute_stats(col: Column) -> Optional[ColStats]:
    """Compute (and cache) ColStats for a column; None for unsupported dtypes."""
    if col.stats is not None:
        return col.stats
    if col.stats_ref is not None:
        st = compute_stats(col.stats_ref)
        col.stats = st
        return st
    k = col.dtype.kind
    if k in (Kind.STRING, Kind.DICTIONARY):
        nd = len(col.dictionary) if col.dictionary is not None else 0
        st = ColStats(0.0, float(max(nd - 1, 0)), True, False,
                      col.null_count > 0, col.length - col.null_count)
        col.stats = st
        return st
    if k not in _STATS_KINDS:
        return None
    if _is_exact64(col):
        col.stats = _exact_stats(col, _exact_row(col).tolist())
    else:
        col.stats = _float_stats(_float_row(col).tolist())
    return col.stats


def prefetch_stats(cols) -> None:
    """Compute the stats of every column of ``cols`` that has none yet in
    one batch: each column's row of reductions is stacked on the device and
    read with one host copy (the f64 rows as their int64 bits beside the
    exact rows), so a later ``compute_stats`` finds them cached."""
    todo = [c for c in cols if isinstance(c, Column) and c.stats is None
            and c.stats_ref is None and c.dtype.kind in _STATS_KINDS]
    if not todo:
        return
    rows = [_exact_row(c) if _is_exact64(c) else _float_row(c).view(torch.int64)
            for c in todo]
    flat = torch.cat(rows).cpu()
    at = 0
    for c, r in zip(todo, rows):
        vals = flat[at:at + r.numel()]
        at += r.numel()
        c.stats = (_exact_stats(c, vals.tolist()) if _is_exact64(c)
                   else _float_stats(vals.view(torch.float64).tolist()))


def grouping_code(col: Column, st: ColStats):
    """One int32 code a row, monotone in sort order (values ascending, then
    NaN, then null), for an integral-codeable column given its stats.
    Returns (code, width_bits)."""
    w = st.code_width()
    assert w is not None
    if col.dtype.kind == Kind.FLOAT:
        code = (col.data.to(torch.float64) - st.vmin).to(torch.int64)
        code = torch.where(torch.isnan(col.data), st.value_range, code)
    else:
        shift = _I64_MIN if col.data.dtype == torch.uint64 else 0
        code = as_int64(col) - (int(st.vmin) + shift)
    if col.validity is not None:
        code = torch.where(col.validity, code, st.value_range + (1 if st.has_nan else 0))
    return code.clamp(0, (1 << min(w, 30)) - 1).to(torch.int32), w


def decode_group_code(code: torch.Tensor, col: Column, st: ColStats):
    """Inverse of grouping_code: (data, validity or None) in col's dtype."""
    nan_code = st.value_range
    null_code = st.value_range + (1 if st.has_nan else 0)
    phys = col.dtype.physical
    code = code.to(torch.int64)
    if col.dtype.kind == Kind.FLOAT:
        data = (code.to(torch.float64) + st.vmin).to(phys)
        if st.has_nan:
            data = torch.where(code == nan_code, float("nan"), data)
    elif phys == torch.uint64:
        data = ((code + (int(st.vmin) + _I64_MIN)) ^ _I64_MIN).view(phys)
    else:
        data = (code + int(st.vmin)).to(phys)
    validity = None
    if st.has_null:
        validity = code != null_code
        data = torch.where(validity, data, torch.zeros((), dtype=phys, device=data.device))
    return data, validity
