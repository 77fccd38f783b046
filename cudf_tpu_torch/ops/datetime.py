"""Datetime field extraction and rounding on int64 epoch timestamps
(counterpart of ``cudf_tpu/ops/datetime.py``).

Analog of cpp/src/datetime/datetime_ops.cu. Civil-calendar math is Howard
Hinnant's integer algorithm (public domain), as torch int64 ops on the
column's device. Fields are int16, as in the reference, except where the
reference is wrong (ROADMAP section 3): ``microsecond`` and ``nanosecond``
are int32 with pandas' values (microseconds within the second,
nanoseconds within the microsecond), and ``day_of_year`` is pandas' (the
reference's int16 results overflow or are off). ``weekday`` is ISO,
Monday = 1 (cuDF's convention; pandas' ``dayofweek`` + 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import Kind
from .strings import _dict_values, _host_table, _table_gather

_PER_SECOND = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def _civil(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day)."""
    z = days.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"),
                    365, rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> days since 1970-01-01."""
    y = y - (m <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    doy = torch.div(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5,
                    rounding_mode="floor") + d - 1
    doe = yoe * 365 + torch.div(yoe, 4, rounding_mode="floor") \
        - torch.div(yoe, 100, rounding_mode="floor") + doy
    return era * 146097 + doe - 719468


def _split_ticks(col: Column):
    """(ticks, per_second, days, ticks within the day) of a timestamp column."""
    if col.dtype.kind != Kind.TIMESTAMP:
        raise TypeError(f"datetime op on {col.dtype}")
    per_s = _PER_SECOND[col.dtype.param or "ns"]
    per_day = 86400 * per_s
    ticks = col.data
    days = torch.div(ticks, per_day, rounding_mode="floor")
    return ticks, per_s, days, ticks - days * per_day


def extract(col: Column, field: str) -> Column:
    """Extract a datetime field: year, month, day, weekday, hour, minute,
    second, millisecond, microsecond, nanosecond or day_of_year."""
    ticks, per_s, days, in_day = _split_ticks(col)
    secs_in_day = torch.div(in_day, per_s, rounding_mode="floor")
    sub = in_day - secs_in_day * per_s  # ticks within the second
    out_dtype = dtypes.int16
    if field in ("year", "month", "day"):
        y, m, d = _civil(days)
        out = {"year": y, "month": m, "day": d}[field]
    elif field == "weekday":
        out = torch.remainder(days + 3, 7) + 1  # 1970-01-01 was a Thursday
    elif field == "hour":
        out = torch.div(secs_in_day, 3600, rounding_mode="floor")
    elif field == "minute":
        out = torch.remainder(torch.div(secs_in_day, 60, rounding_mode="floor"), 60)
    elif field == "second":
        out = torch.remainder(secs_in_day, 60)
    elif field == "millisecond":
        out = sub * 1000 // per_s
    elif field == "microsecond":
        out_dtype = dtypes.int32
        out = sub * 10**6 // per_s if per_s <= 10**6 else sub // (per_s // 10**6)
    elif field == "nanosecond":
        out_dtype = dtypes.int32
        out = torch.remainder(sub, 1000) if per_s == 10**9 else torch.zeros_like(sub)
    elif field == "day_of_year":
        y, _, _ = _civil(days)
        one = torch.ones_like(y)
        out = days - _days_from_civil(y, one, one) + 1
    else:
        raise ValueError(f"unknown field {field}")
    return Column(out_dtype, out.to(out_dtype.physical), col.validity, col.length)


def truncate(col: Column, freq: str) -> Column:
    """Floor timestamps to day, month or year boundaries (cudf::datetime::floor)."""
    _, per_s, days, _ = _split_ticks(col)
    if freq == "D":
        out_days = days
    else:
        y, m, d = _civil(days)
        one = torch.ones_like(d)
        if freq == "M":
            out_days = _days_from_civil(y, m, one)
        elif freq == "Y":
            out_days = _days_from_civil(y, one, one)
        else:
            raise ValueError(freq)
    return Column(col.dtype, out_days * (86400 * per_s), col.validity, col.length)


def timestamp_from_strings(col: Column, fmt: str = "%Y-%m-%d") -> Column:
    """Parse dictionary-encoded date strings on the host, once per value;
    a value that does not parse is NaT."""
    from ..utils.real_pandas import pd

    d = _dict_values(col)
    parsed = pd.to_datetime(list(d), format=fmt, errors="coerce")
    ticks = np.asarray(parsed.values.astype("datetime64[ns]").view("int64"))
    out = _table_gather(_host_table(ticks, col), col.data)
    return Column(dtypes.timestamp("ns"), out, col.validity, col.length)


_FREQ_NS = {"D": 86_400_000_000_000, "h": 3_600_000_000_000, "H": 3_600_000_000_000,
            "min": 60_000_000_000, "T": 60_000_000_000, "s": 1_000_000_000,
            "S": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}


def _in_ns(col: Column):
    """(the ticks in nanoseconds, ns a tick) of a timestamp column."""
    scale = 10**9 // _PER_SECOND[col.dtype.param or "ns"]
    return col.data.to(torch.int64) * scale, scale


def ceil_timestamps(col: Column, freq: str) -> Column:
    """cudf::datetime::ceil_datetimes."""
    step = _FREQ_NS[freq]
    v, scale = _in_ns(col)
    out = torch.div(v + step - 1, step, rounding_mode="floor") * step // scale
    return Column(col.dtype, out, col.validity, col.length)


def floor_timestamps(col: Column, freq: str) -> Column:
    step = _FREQ_NS[freq]
    v, scale = _in_ns(col)
    out = torch.div(v, step, rounding_mode="floor") * step // scale
    return Column(col.dtype, out, col.validity, col.length)


def round_timestamps(col: Column, freq: str) -> Column:
    step = _FREQ_NS[freq]
    v, scale = _in_ns(col)
    out = torch.div(v + step // 2, step, rounding_mode="floor") * step // scale
    return Column(col.dtype, out, col.validity, col.length)


def is_leap_year(col: Column) -> Column:
    y = extract(col, "year").data
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return Column(dtypes.bool_, leap, col.validity, col.length)


_MONTH_DAYS = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], np.int32)


def days_in_month(col: Column) -> Column:
    m = extract(col, "month").data.to(torch.int64)
    leap = is_leap_year(col).data
    base = torch.from_numpy(_MONTH_DAYS).to(col.device)
    d = base[m.clamp(0, 12)]
    d = torch.where((m == 2) & leap, 29, d).to(torch.int32)
    return Column(dtypes.int32, d, col.validity, col.length)


def quarter(col: Column) -> Column:
    m = extract(col, "month").data.to(torch.int32)
    return Column(dtypes.int32, torch.div(m - 1, 3, rounding_mode="floor") + 1,
                  col.validity, col.length)
