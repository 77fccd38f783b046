"""The port's windows (``cudf_tpu_torch/ops/rolling.py`` and
``ops/grouped_window.py``) against cudf_tpu's and pandas.

Columns made from a seed with numpy, with NaN and nulls, go through both
packages (the port on the CPU) and pandas: fixed windows of every kind,
centred or not, shift and diff, range windows on an orderby column,
windows from explicit bounds, and the grouped scans, shifts and rolling
sums. Masks are exact, values rtol 1e-12 against the reference (the same
prefix-sum differences) and, where pandas sums in another order, rtol 1e-9
against pandas (the reference's own test tolerance). Faults of the
reference are pinned where the port equals pandas: ``count`` with
``min_periods`` and the grouped ``cummax``.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import grouped_window as rgw
from cudf_tpu.ops import rolling as rroll

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import grouped_window as tgw
from cudf_tpu_torch.ops import rolling as troll

N = 500


def _x(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N) * 10
    x[rng.random(N) < 0.1] = np.nan
    x[100:104] = np.nan  # a window of only NaN
    return x


def _cols(values, **kw):
    r = ct.Column.from_numpy(np.asarray(values), **kw)
    t = tt.Column.from_numpy(np.asarray(values), device="cpu",
                             **{k: v for k, v in kw.items()})
    return r, t


def _np(col):
    return np.asarray(col.to_numpy(), dtype=np.float64)[: col.length]


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12, equal_nan=True)


KINDS = ["sum", "mean", "min", "max", "var", "std"]


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("window,min_periods", [(3, None), (7, 2), (16, 1)])
@pytest.mark.parametrize("kind", KINDS)
def test_rolling_matches_reference_and_pandas(kind, window, min_periods, center):
    x = _x()
    r, t = _cols(x)
    got = _np(troll.rolling(t, window, kind, min_periods, center))
    _close(got, _np(rroll.rolling(r, window, kind, min_periods, center)), 1e-12)
    if not center:  # the reference centres an even split differently
        want = getattr(pd.Series(x).rolling(window, min_periods=min_periods), kind)()
        _close(got, want.to_numpy(), 1e-9)


@pytest.mark.parametrize("window,min_periods", [(3, None), (4, 1), (5, 3)])
def test_rolling_count_follows_pandas(window, min_periods):
    """pandas' count needs ``min_periods`` rows in the window; the
    reference needs that many valid values, so a window of NaN gives it
    null where pandas and the port give 0."""
    x = _x()
    r, t = _cols(x)
    got = _np(troll.rolling(t, window, "count", min_periods))
    want = pd.Series(x).rolling(window, min_periods=min_periods).count().to_numpy()
    _close(got, want, 0)
    ref = _np(rroll.rolling(r, window, "count", min_periods))
    apart = ~np.isnan(got) & np.isnan(ref)
    assert apart.any()  # the reference's nulls where pandas counts
    _close(got[~apart], ref[~apart], 0)


@pytest.mark.parametrize("periods", [1, 2, -1, -3])
@pytest.mark.parametrize("dtype", ["int64", "float32", "nullable"])
def test_shift_and_diff(dtype, periods):
    rng = np.random.default_rng(1)
    vals = rng.integers(-100, 100, N)
    valid = None
    if dtype == "nullable":
        valid = rng.random(N) > 0.1
    elif dtype == "float32":
        vals = vals.astype(np.float32)
    r, t = _cols(vals, validity=valid)
    for fn in ("shift", "diff"):
        got = getattr(troll, fn)(t, periods)
        want = getattr(rroll, fn)(r, periods)
        np.testing.assert_array_equal(got.validity[:N].numpy(), np.asarray(want.validity)[:N])
        _close(_np(got), _np(want), 0)
    s = pd.Series(np.where(valid, vals, np.nan) if valid is not None else vals)
    _close(_np(troll.diff(t, periods)), s.diff(periods).to_numpy(), 1e-12)


def _range_input():
    rng = np.random.default_rng(0)
    ob = np.sort(rng.integers(0, 1000, 200)).astype(np.int64)
    x = rng.standard_normal(200)
    x[rng.random(200) < 0.1] = np.nan
    return ob, x


@pytest.mark.parametrize("closed", ["right", "both", "left", "neither"])
@pytest.mark.parametrize("kind", ["sum", "mean", "min", "max", "count", "std"])
def test_rolling_range(kind, closed):
    """tests/test_windows_lists.py's case, every closed variant."""
    ob, x = _range_input()
    rx, tx = _cols(x)
    ro, to = _cols(ob)
    got = _np(troll.rolling_range(tx, to, 50, kind, 1, closed))
    _close(got, _np(rroll.rolling_range(rx, ro, 50, kind, 1, closed)), 1e-12)
    if closed == "right":
        s = pd.Series(x, index=pd.to_datetime(ob, unit="ns"))
        want = getattr(s.rolling("50ns", min_periods=1), kind)().to_numpy()
        _close(got, want, 1e-12)


@pytest.mark.parametrize("kind", ["sum", "mean", "min", "max", "count", "var"])
def test_rolling_variable(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=64)
    starts = np.maximum(np.arange(64) - rng.integers(0, 6, 64), 0).astype(np.int32)
    ends = np.minimum(np.arange(64) + rng.integers(1, 4, 64), 64).astype(np.int32)
    rx, tx = _cols(x)
    rs, ts = _cols(starts)
    re_, te = _cols(ends)
    got = _np(troll.rolling_variable(tx, ts, te, kind))
    _close(got, _np(rroll.rolling_variable(rx, rs, re_, kind)), 1e-12)
    agg = {"sum": np.sum, "mean": np.mean, "min": np.min, "max": np.max,
           "count": len, "var": lambda a: np.var(a, ddof=1)}[kind]
    want = np.array([agg(x[s:e]) if e - s > (kind == "var") else np.nan
                     for s, e in zip(starts, ends)], np.float64)
    _close(got, want, 1e-9)


# ------------------------------------------------------------ grouped windows
def _gdf():
    rng = np.random.default_rng(11)  # tests/test_streaming.py's TestGroupedWindow
    v = rng.normal(size=300)
    v[rng.random(300) < 0.1] = np.nan
    return pd.DataFrame({"k": rng.integers(0, 6, 300), "k2": rng.integers(0, 2, 300),
                         "v": v, "w": rng.integers(-9, 9, 300)})


def _tables(df):
    return ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")


@pytest.mark.parametrize("keys", [["k"], ["k", "k2"]])
@pytest.mark.parametrize("kind,value", [("cumsum", "w"), ("cumsum", "v"),
                                        ("cumcount", "v"), ("row_number", "v")])
def test_grouped_scan(kind, value, keys):
    df = _gdf()
    r, t = _tables(df)
    got = tgw.grouped_scan(t, keys, value, kind)
    want = rgw.grouped_scan(r, keys, value, kind)
    assert tt.dtypes.to_numpy(got.dtype) == ct.dtypes.to_numpy(want.dtype)
    _close(_np(got), _np(want), 1e-12)
    g = df.groupby(keys)[value]
    p = {"cumsum": lambda: g.cumsum(), "cumcount": lambda: g.count().reindex() * 0,
         "row_number": lambda: g.cumcount() + 1}
    if kind != "cumcount" and not (kind == "cumsum" and value == "v"):
        # the op keeps a NaN as a value (cuDF); the frame's cumsum skips it
        _close(_np(got), p[kind]().to_numpy(np.float64), 1e-12)


def test_grouped_cummax_equals_pandas():
    """The reference restarts its running max by adding group_index·1e18 in
    f64, which rounds every later group's values; the port's equals
    pandas."""
    df = _gdf()
    df["v"] = df["v"].fillna(0.0)
    r, t = _tables(df)
    got = _np(tgw.grouped_scan(t, ["k"], "v", "cummax"))
    want = df.groupby("k")["v"].cummax().to_numpy()
    np.testing.assert_array_equal(got, want)
    ref = _np(rgw.grouped_scan(r, ["k"], "v", "cummax"))
    assert not np.allclose(ref, want, rtol=1e-6)


@pytest.mark.parametrize("periods", [1, 2, -1])
def test_grouped_shift(periods):
    df = _gdf()
    r, t = _tables(df)
    for value in ("v", "w"):
        got = tgw.grouped_shift(t, ["k"], value, periods)
        want = rgw.grouped_shift(r, ["k"], value, periods)
        np.testing.assert_array_equal(got.validity[:300].numpy(),
                                      np.asarray(want.validity)[:300])
        _close(_np(got), _np(want), 0)
        _close(_np(got), df.groupby("k")[value].shift(periods).to_numpy(np.float64), 0)


@pytest.mark.parametrize("window,min_periods", [(3, None), (4, 1)])
@pytest.mark.parametrize("kind", ["sum", "mean", "count"])
def test_grouped_rolling(kind, window, min_periods):
    df = _gdf()
    r, t = _tables(df)
    got = _np(tgw.grouped_rolling(t, ["k"], "v", window, kind, min_periods))
    want = (getattr(df.groupby("k")["v"].rolling(window, min_periods=min_periods), kind)()
            .reset_index(level=0, drop=True).sort_index().to_numpy())
    _close(got, want, 1e-9)
    ref = _np(rgw.grouped_rolling(r, ["k"], "v", window, kind, min_periods))
    if kind == "count":  # the reference's count: min_periods VALID values
        apart = ~np.isnan(got) & np.isnan(ref)
        got, ref = got[~apart], ref[~apart]
    _close(got, ref, 1e-12)


# --------------------------------------------------------------- the frame
def test_series_windows_through_the_frame():
    """Series.shift/diff/rolling and the frame's shift/diff equal the
    reference's and pandas'."""
    x = pd.Series(_x(3), name="x")
    for pkg in ("ref", "port"):
        s = ct.Series(x) if pkg == "ref" else tt.Series(x, device="cpu")
        for got, want in ((s.shift(1), x.shift(1)), (s.diff(), x.diff()),
                          (s.rolling(7).mean(), x.rolling(7).mean()),
                          (s.rolling(7, min_periods=1).max(),
                           x.rolling(7, min_periods=1).max()),
                          (s.pct_change(), x.pct_change(fill_method=None))):
            _close(got.to_pandas().to_numpy(np.float64), want.to_numpy(np.float64), 1e-9)
