"""Rolling windows: fixed-size, range-based and variable windows
(counterpart of ``cudf_tpu/ops/rolling.py``).

Analog of cpp/src/rolling/. Fault of the reference not copied: its
``count`` needs ``min_periods`` VALID values in a window, where pandas
needs that many rows (a window of rows that are all null counts 0, not
null); here it equals pandas. As in the reference, a window's sum and count
are differences of f64 prefix sums over the column (so a window's sum
carries an error of a few ulps of the running total, as the reference's
does), min/max over a fixed window combine log2(w) shifted copies, and
min/max over per-row bounds read a sparse table (log2(n) doubling levels
and two lookups a row).
"""
from __future__ import annotations

import torch

from ..core import dtypes
from ..core.column import Column

_INF = float("inf")


def _shifted(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x shifted right by k rows, the first k filled."""
    if k == 0:
        return x
    return torch.cat([torch.full((k,), fill, dtype=x.dtype, device=x.device), x[:-k]])


def _valid_values(col: Column) -> torch.Tensor:
    valid = col.valid_mask()
    if col.dtype.is_floating:
        valid = valid & ~torch.isnan(col.data)
    return valid


def rolling(col: Column, window: int, kind: str = "sum",
            min_periods: int = None, center: bool = False) -> Column:
    """Fixed-window rolling aggregate (sum/mean/min/max/count/var/std),
    f64 with nulls where fewer than ``min_periods`` values are valid."""
    mp = window if min_periods is None else min_periods
    valid = _valid_values(col)
    x64 = col.data.to(torch.float64)
    xz = torch.where(valid, x64, 0.0)
    w = window
    csum = torch.cumsum(xz, 0)
    ccnt = torch.cumsum(valid.to(torch.int64), 0)
    wsum = csum - _shifted(csum, w, 0.0)
    wcnt = ccnt - _shifted(ccnt, w, 0)
    out_valid = wcnt >= mp
    if kind in ("min", "max"):
        ident = _INF if kind == "min" else -_INF
        fn = torch.minimum if kind == "min" else torch.maximum
        out = torch.where(valid, x64, ident)
        k = 1
        while k < w:  # doubling windows: shifted copies cover width w
            step = min(k, w - k)
            out = fn(out, _shifted(out, step, ident))
            k += step
    elif kind == "count":
        # pandas: min_periods counts the window's rows, valid or not
        rows = (torch.arange(col.capacity, device=col.device) + 1).clamp(max=w)
        out, out_valid = wcnt.to(torch.float64), (rows >= mp) & col.bounds_mask()
    elif kind == "sum":
        out = wsum
    elif kind == "mean":
        out = wsum / wcnt.clamp(min=1)
    elif kind in ("var", "std"):
        csq = torch.cumsum(torch.where(valid, x64 * x64, 0.0), 0)
        wsq = csq - _shifted(csq, w, 0.0)
        mean = wsum / wcnt.clamp(min=1)
        m2 = (wsq - wcnt * mean * mean).clamp(min=0.0)
        denom = wcnt - 1
        out = torch.where(denom > 0, m2 / denom.clamp(min=1), float("nan"))
        if kind == "std":
            out = torch.sqrt(out)
        out_valid = out_valid & (denom > 0)
    else:
        raise ValueError(f"rolling kind {kind!r}")
    out = torch.where(out_valid, out, float("nan"))
    if center:
        lead = window // 2
        out = torch.cat([out[lead:], out.new_full((lead,), float("nan"))])
        out_valid = torch.cat([out_valid[lead:], out_valid.new_zeros(lead)])
    return Column(dtypes.float64, out, out_valid, col.length)


def shift(col: Column, periods: int = 1) -> Column:
    """cudf::shift (cpp/src/copying/shift.cu): lag/lead with null fill."""
    v = col.valid_mask()
    if periods >= 0:
        data = _shifted(col.data, periods, 0)
        valid = _shifted(v, periods, False)
    else:
        k = -periods
        data = torch.cat([col.data[k:], col.data.new_zeros(k)])
        valid = torch.cat([v[k:], v.new_zeros(k)])
        pos = torch.arange(col.capacity, device=col.device)
        valid = valid & (pos < col.length - k)
    return Column(col.dtype, data, valid, col.length, col.dictionary)


def diff(col: Column, periods: int = 1) -> Column:
    from .binaryop import binary_op

    return binary_op(col, shift(col, periods), "sub")


# ---------------------------------------------------------------------------
# range-based windows and windows from explicit bounds
# ---------------------------------------------------------------------------
# Per-row [start, end) bounds come from a binary search on the (monotonic)
# orderby column; sums and counts read exclusive prefix sums at the bounds;
# min/max read a sparse table.

def _bitlen(v: torch.Tensor, maxbits: int) -> torch.Tensor:
    """floor(log2(v)) + 1 for v > 0, 0 for v = 0."""
    bl = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    for k in range(maxbits):
        bl += (v > (1 << k) - 1).to(torch.int64)
    return bl


def _rmq_levels(x: torch.Tensor, fn, ident) -> torch.Tensor:
    """Sparse table: levels[k][i] = reduce over x[i : i + 2^k]."""
    n = x.shape[0]
    levels = [x]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        sh = 1 << (k - 1)
        levels.append(fn(prev, torch.cat([prev[sh:], prev.new_full((sh,), ident)])))
        k += 1
    return torch.stack(levels)


def _rmq_query(levels: torch.Tensor, starts, ends, fn, ident) -> torch.Tensor:
    """Reduce over [starts, ends) per row from a sparse table."""
    L = ends - starts
    k = (_bitlen(L, levels.shape[0]) - 1).clamp(min=0)
    n = levels.shape[1]
    a = levels[k, starts.clamp(0, n - 1)]
    b = levels[k, (ends - (torch.ones_like(k) << k)).clamp(0, n - 1)]
    return torch.where(L > 0, fn(a, b), ident)


def _window_agg(x64, valid, starts, ends, kind: str, mp: int):
    """Aggregate x64 over per-row [starts, ends) windows: (out, ok)."""
    cap = x64.shape[0]

    def excl(c):
        return torch.cat([c.new_zeros(1), torch.cumsum(c, 0)])

    s = starts.to(torch.int64).clamp(0, cap)
    e = torch.maximum(ends.to(torch.int64).clamp(max=cap), s)
    ccnt = excl(valid.to(torch.int64))
    wcnt = ccnt[e] - ccnt[s]
    ok = wcnt >= mp
    if kind == "count":  # pandas: min_periods counts the window's rows
        return wcnt.to(torch.float64), (e - s) >= mp
    csum = excl(torch.where(valid, x64, 0.0))
    wsum = csum[e] - csum[s]
    if kind == "sum":
        return wsum, ok
    if kind == "mean":
        return wsum / wcnt.clamp(min=1), ok
    if kind in ("var", "std"):
        csq = excl(torch.where(valid, x64 * x64, 0.0))
        wsq = csq[e] - csq[s]
        mean = wsum / wcnt.clamp(min=1)
        m2 = (wsq - wcnt * mean * mean).clamp(min=0.0)
        denom = wcnt - 1
        out = torch.where(denom > 0, m2 / denom.clamp(min=1), float("nan"))
        if kind == "std":
            out = torch.sqrt(out)
        return out, ok & (denom > 0)
    if kind in ("min", "max"):
        ident = _INF if kind == "min" else -_INF
        fn = torch.minimum if kind == "min" else torch.maximum
        levels = _rmq_levels(torch.where(valid, x64, ident), fn, ident)
        out = _rmq_query(levels, s, e, fn, ident)
        return out, ok & torch.isfinite(out)
    raise ValueError(f"rolling kind {kind!r}")


def rolling_range(col: Column, orderby: Column, window, kind: str = "sum",
                  min_periods: int = 1, closed: str = "right") -> Column:
    """Value-based rolling window (pandas ``rolling("2D")`` analog).

    ``orderby`` must be increasing; the window of row i covers rows j <= i
    with orderby[j] in (orderby[i] - window, orderby[i]] for
    closed='right', with the usual closed variants. ``window`` is in
    orderby's physical units (ns for datetimes)."""
    inb = col.bounds_mask()
    ob = torch.where(inb, orderby.data.to(torch.int64), torch.iinfo(torch.int64).max)
    lo = ob - int(window)
    starts = torch.searchsorted(ob, lo, right=closed in ("right", "neither"))
    # the right edge is positional (rows <= i), as in pandas: later rows
    # with the current row's orderby value do not enter its window
    ends = torch.arange(col.capacity, device=col.device) + 1
    if closed not in ("right", "both"):
        ends = torch.minimum(ends, torch.searchsorted(ob, ob, right=False))
    out, ok = _window_agg(col.data.to(torch.float64), _valid_values(col), starts,
                          ends, kind, min_periods)
    ok = ok & inb
    return Column(dtypes.float64, torch.where(ok, out, float("nan")), ok, col.length)


def rolling_variable(col: Column, starts: Column, ends: Column,
                     kind: str = "sum", min_periods: int = 1) -> Column:
    """Windows from explicit per-row [start, end) bounds (offsets API)."""
    out, ok = _window_agg(col.data.to(torch.float64), _valid_values(col),
                          starts.data, ends.data, kind, min_periods)
    ok = ok & col.bounds_mask()
    return Column(dtypes.float64, torch.where(ok, out, float("nan")), ok, col.length)
