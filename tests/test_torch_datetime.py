"""The port's datetime ops (``ops/datetime.py``) against cudf_tpu's and
pandas.

The same timestamps, made from a numpy seed, in s, ms, us and ns units,
with dates before 1970, leap days, century years and nulls, go through
both packages (the port on the CPU). Every result must be equal exactly,
values and null masks. Some results of the reference are wrong (ROADMAP
section 3): ``extract`` of ``microsecond`` and ``nanosecond`` (int16
overflow) and of ``day_of_year``, ``truncate`` to ``M`` and ``Y`` (a day
count from 0000-03-01 instead of 1970-01-01), and
``timestamp_from_strings`` under pandas 3 (ticks of a coarser unit
read as ns). There the
port equals pandas, and a test pins the reference's answer as it is.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import datetime as RD

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import datetime as TD

UNITS = ["s", "ms", "us", "ns"]
FIELDS = ["year", "month", "day", "weekday", "hour", "minute", "second", "millisecond",
          "microsecond", "nanosecond", "day_of_year"]
REFERENCE_FAULTS = {"microsecond", "nanosecond", "day_of_year"}


def _stamps(unit, n=400, seed=0):
    """datetime64[unit] values from 1900 to 2100 with sub-second parts, the
    three values that show the reference's faults, leap days and ends of
    years, and 5% NaT."""
    rng = np.random.default_rng(seed)
    lo, hi = np.datetime64("1900-01-01", "ns").astype(np.int64), \
        np.datetime64("2100-12-31", "ns").astype(np.int64)
    ns = rng.integers(lo, hi, n)
    fixed = np.array(["2021-03-04T05:06:07.123456789", "1969-12-31T23:59:59.999999",
                      "2000-02-29", "1900-02-28T23:59:59", "1970-01-01", "2024-12-31T12:00",
                      "1600-03-01", "2096-02-29T01:02:03.000004005"], "datetime64[ns]")
    vals = np.concatenate([fixed, ns.astype("datetime64[ns]")]).astype(f"datetime64[{unit}]")
    vals[rng.random(len(vals)) < 0.05] = np.datetime64("NaT")
    return vals


def _cols(unit):
    vals = _stamps(unit)
    valid = ~np.isnat(vals)
    return (vals, ct.Column.from_numpy(vals, validity=valid),
            tt.Column.from_numpy(vals, validity=valid, device="cpu"))


def assert_same(got, want):
    assert (got.dtype.kind, got.dtype.bits, got.dtype.param) == \
        (want.dtype.kind, want.dtype.bits, want.dtype.param)
    n = want.length
    np.testing.assert_array_equal(got.validity[:n].numpy(), np.asarray(want.validity)[:n])
    ok = np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(got.data[:n].numpy()[ok], np.asarray(want.data)[:n][ok])


def _pandas_field(vals, field):
    s = pd.Series(vals).dt
    if field == "weekday":
        return s.dayofweek + 1  # ISO, Monday = 1
    if field == "millisecond":
        return s.microsecond // 1000
    return getattr(s, field)


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("field", FIELDS)
def test_extract_matches_reference_and_pandas(unit, field):
    vals, rc, tc = _cols(unit)
    got = TD.extract(tc, field)
    ok = ~np.isnat(vals)
    np.testing.assert_array_equal(got.validity[: len(vals)].numpy(), ok)
    np.testing.assert_array_equal(got.data[: len(vals)].numpy()[ok],
                                  _pandas_field(vals, field).to_numpy()[ok])
    if field in REFERENCE_FAULTS:
        assert got.dtype.bits == (16 if field == "day_of_year" else 32)
    else:
        assert_same(got, RD.extract(rc, field))


def test_extract_reference_faults_are_pinned():
    """Three probe values: the reference's int16 overflow and its
    day_of_year stay as they are; the port gives pandas' values."""
    vals = np.array(["2021-03-04T05:06:07.123456789", "1969-12-31T23:59:59.999999",
                     "2000-02-29"], "datetime64[ns]")
    rc, tc = ct.Column.from_numpy(vals), tt.Column.from_numpy(vals, device="cpu")
    want = {"microsecond": [123456, 999999, 0], "nanosecond": [789, 0, 0],
            "day_of_year": [63, 365, 60]}
    wrong = {"microsecond": [-7616, 16959, 0], "nanosecond": [-13035, -14824, 0],
             "day_of_year": [1491, 1793, 1488]}
    for field in want:
        assert TD.extract(tc, field).to_numpy().tolist() == want[field]
        assert RD.extract(rc, field).to_numpy().tolist() == wrong[field]
        assert _pandas_field(vals, field).tolist() == want[field]


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("freq", ["D", "M", "Y"])
def test_truncate_matches_pandas(unit, freq):
    vals, rc, tc = _cols(unit)
    got = TD.truncate(tc, freq)
    ok = ~np.isnat(vals)
    want = pd.Series(vals).dt.to_period(freq).dt.start_time.to_numpy()
    np.testing.assert_array_equal(got.to_numpy()[ok], want[ok].astype(vals.dtype))
    if freq == "D":
        assert_same(got, RD.truncate(rc, freq))


def test_truncate_reference_fault_is_pinned():
    vals = np.array(["2021-03-04T05:06:07"], "datetime64[ns]")
    rc, tc = ct.Column.from_numpy(vals), tt.Column.from_numpy(vals, device="cpu")
    for freq, start in (("M", "2021-03-01"), ("Y", "2021-01-01")):
        assert TD.truncate(tc, freq).to_numpy()[0] == np.datetime64(start, "ns")
        assert RD.truncate(rc, freq).to_numpy()[0] != np.datetime64(start, "ns")


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("freq", ["D", "h", "min", "s", "ms"])
def test_ceil_floor_round_match_reference(unit, freq):
    _, rc, tc = _cols(unit)
    for fn in ("ceil_timestamps", "floor_timestamps", "round_timestamps"):
        assert_same(getattr(TD, fn)(tc, freq), getattr(RD, fn)(rc, freq))


@pytest.mark.parametrize("unit", UNITS)
def test_calendar_predicates_match_reference(unit):
    _, rc, tc = _cols(unit)
    for fn in ("is_leap_year", "days_in_month", "quarter"):
        assert_same(getattr(TD, fn)(tc), getattr(RD, fn)(rc))


def test_reference_cases():
    """tests/test_long_tail.py's datetime cases."""
    ts = pd.to_datetime(["2024-03-01 10:17:45", "2024-03-01 23:59:59"])
    c = tt.Column.from_numpy(ts.values, device="cpu")
    for freq in ("h", "D", "min"):
        np.testing.assert_array_equal(TD.floor_timestamps(c, freq).to_numpy(),
                                      ts.floor(freq).values)
        np.testing.assert_array_equal(TD.ceil_timestamps(c, freq).to_numpy(),
                                      ts.ceil(freq).values)
        np.testing.assert_array_equal(TD.round_timestamps(c, freq).to_numpy(),
                                      ts.round(freq).values)
    leap = TD.is_leap_year(tt.Column.from_numpy(
        pd.to_datetime(["2024-01-01", "2023-01-01"]).values, device="cpu"))
    np.testing.assert_array_equal(leap.to_numpy(), [True, False])
    dim = TD.days_in_month(tt.Column.from_numpy(
        pd.to_datetime(["2024-02-10", "2023-02-10", "2023-04-01"]).values, device="cpu"))
    np.testing.assert_array_equal(dim.to_numpy(), [29, 28, 30])
    q = TD.quarter(tt.Column.from_numpy(pd.to_datetime(["2024-05-01"]).values, device="cpu"))
    assert int(q.to_numpy()[0]) == 2


def test_timestamp_from_strings_equals_pandas():
    """Parsed to ns, as pandas gives. The reference reads pandas' result as
    int64 without fixing its unit, and pandas 3 parses these dates at
    a coarser resolution, so its ticks are read as ns in the wrong unit (ROADMAP
    section 3); that is pinned as it is."""
    vals = np.array(["2021-03-04", "1969-12-31", "bad", None, "2000-02-29"], object)
    df = pd.DataFrame({"s": vals})
    rc, tc = ct.Table.from_pandas(df)["s"], tt.Table.from_pandas(df, device="cpu")["s"]
    want = pd.to_datetime(pd.Series(vals), format="%Y-%m-%d", errors="coerce")
    want = want.to_numpy().astype("datetime64[ns]")
    got = TD.timestamp_from_strings(tc)
    assert got.dtype.param == "ns"
    np.testing.assert_array_equal(got.to_numpy(), want)
    ref = RD.timestamp_from_strings(rc).to_numpy().astype(np.int64)
    ratio = want[0].astype(np.int64) // ref[0]
    assert ratio in (10**3, 10**6, 10**9) and ref[0] * ratio == want[0].astype(np.int64)


def test_extract_rejects_non_timestamps():
    c = tt.Column.from_numpy(np.arange(3), device="cpu")
    with pytest.raises(TypeError):
        TD.extract(c, "year")
