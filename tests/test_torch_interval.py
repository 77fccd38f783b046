"""The port's interval columns and binning (``core/interval.py``) against
cudf_tpu's and pandas.

``cut`` and ``qcut`` codes must equal ``pandas.cut``/``pandas.qcut``
exactly, and the reference's codes and labels wherever the reference
agrees with pandas; where it does not, the fault is pinned. Interval
arithmetic (mid, width, contains, overlaps) is exact against the
reference.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.core import interval as RI

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import interval as TI


def _codes(col):
    """int codes with -1 for a null, from either package's column."""
    n = col.length
    codes = np.asarray(col.data)[:n].astype(np.int64) if not hasattr(col.data, "numpy") \
        else col.data[:n].numpy().astype(np.int64)
    if col.validity is not None:
        v = np.asarray(col.validity)[:n] if not hasattr(col.validity, "numpy") \
            else col.validity[:n].numpy()
        codes = np.where(v, codes, -1)
    return codes


def _values(kind, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "f64":
        x = np.round(rng.normal(50, 20, n), 2)
    elif kind == "f32":
        x = rng.uniform(900.0, 105000.0, n).astype(np.float32)
    else:
        x = rng.integers(-40, 200, n)
    df = pd.DataFrame({"x": x})
    if kind != "int":
        df.loc[rng.random(n) < 0.03, "x"] = np.nan
    return df["x"]


def _pair(s):
    df = s.to_frame()
    return ct.Table.from_pandas(df)["x"], tt.Table.from_pandas(df, device="cpu")["x"]


@pytest.mark.parametrize("kind", ["f64", "f32", "int"])
@pytest.mark.parametrize("bins", [4, 16, [-50.0, 0.0, 25.0, 60.0, 1000.0, 2e5]])
@pytest.mark.parametrize("include_lowest", [False, True])
def test_cut_codes_equal_pandas(kind, bins, include_lowest):
    s = _values(kind)
    r, t = _pair(s)
    got = TI.cut(t, bins, include_lowest=include_lowest)
    want = pd.cut(s, bins, include_lowest=include_lowest)
    np.testing.assert_array_equal(_codes(got), want.cat.codes.to_numpy())
    if kind != "f32":  # the reference bins f32 data in f64 (pinned below)
        ref = RI.cut(r, bins, include_lowest=include_lowest)
        np.testing.assert_array_equal(_codes(got), _codes(ref))
        assert list(got.dictionary) == list(ref.dictionary)


@pytest.mark.parametrize("kind", ["f64", "int"])
def test_cut_right_false_explicit_bins_and_labels(kind):
    s = _values(kind, seed=1)
    r, t = _pair(s)
    edges = [-100.0, 10.0, 50.0, 90.0, 300.0]
    got = TI.cut(t, edges, right=False, labels=["a", "b", "c", "d"])
    ref = RI.cut(r, edges, right=False, labels=["a", "b", "c", "d"])
    want = pd.cut(s, edges, right=False, labels=["a", "b", "c", "d"])
    np.testing.assert_array_equal(_codes(got), want.cat.codes.to_numpy())
    np.testing.assert_array_equal(_codes(got), _codes(ref))
    assert list(got.dictionary) == ["a", "b", "c", "d"]
    nums = TI.cut(t, edges, labels=False)
    np.testing.assert_array_equal(nums.to_numpy(), RI.cut(r, edges, labels=False).to_numpy())
    assert TI.cut(t, edges).to_pandas().cat.ordered


def test_reference_cut_right_false_with_int_bins_loses_the_maximum():
    """pandas widens the LAST edge for right=False; the reference widens
    the first, so the maximum falls outside every bin."""
    s = _values("f64", seed=2)
    r, t = _pair(s)
    want = pd.cut(s, 5, right=False).cat.codes.to_numpy()
    np.testing.assert_array_equal(_codes(TI.cut(t, 5, right=False)), want)
    ref = _codes(RI.cut(r, 5, right=False))
    top = np.flatnonzero(s.to_numpy() == np.nanmax(s.to_numpy()))
    assert (want[top] == 4).all() and (ref[top] == -1).all()


def test_reference_cut_bins_f32_data_in_f64():
    """On f32 data pandas computes integer bins in f32; the reference in
    f64, so a value on or next to an f32 edge changes bins."""
    rng = np.random.default_rng(3)
    x = rng.uniform(900.0, 105000.0, 1000).astype(np.float32)
    _, edges = pd.cut(pd.Series(x), 16, retbins=True)
    inner = edges[1:-1]
    near = np.concatenate([inner, np.nextafter(inner, np.float32(np.inf)),
                           np.nextafter(inner, np.float32(-np.inf))])
    s = pd.Series(np.concatenate([x, near]).astype(np.float32), name="x")
    r, t = _pair(s)
    want = pd.cut(s, 16).cat.codes.to_numpy()
    np.testing.assert_array_equal(_codes(TI.cut(t, 16)), want)
    assert (_codes(RI.cut(r, 16)) != want).any()


@pytest.mark.parametrize("kind", ["f64", "f32", "int"])
@pytest.mark.parametrize("q", [4, 10, [0.0, 0.1, 0.5, 0.9, 1.0]])
def test_qcut_codes_equal_pandas(kind, q):
    s = _values(kind, seed=4)
    r, t = _pair(s)
    got = TI.qcut(t, q)
    want = pd.qcut(s, q, duplicates="drop")
    np.testing.assert_array_equal(_codes(got), want.cat.codes.to_numpy())
    if kind == "f64":
        np.testing.assert_array_equal(_codes(got), _codes(RI.qcut(r, q)))


def test_constant_column_and_empty_bins():
    s = pd.Series(np.full(50, 7.0), name="x")
    r, t = _pair(s)
    np.testing.assert_array_equal(_codes(TI.cut(t, 3)), pd.cut(s, 3).cat.codes.to_numpy())
    np.testing.assert_array_equal(_codes(TI.cut(t, 3)), _codes(RI.cut(r, 3)))


def test_interval_range_and_arithmetic_match_reference():
    for kw in ({"periods": 5}, {"freq": 2.5}):
        r = RI.interval_range(0.0, 10.0, closed="both", **kw)
        t = TI.interval_range(0.0, 10.0, closed="both", device="cpu", **kw)
        for f in ("left", "right"):
            np.testing.assert_array_equal(getattr(t, f).to_numpy(), getattr(r, f).to_numpy())
        np.testing.assert_array_equal(t.mid().to_numpy(), r.mid().to_numpy())
        np.testing.assert_array_equal(t.width().to_numpy(), r.width().to_numpy())
        for v in (0.0, 2.5, 4.0, 10.0):
            np.testing.assert_array_equal(t.contains(v).to_numpy(), r.contains(v).to_numpy())
        want = pd.interval_range(0.0, 10.0, closed="both", **kw)
        assert list(t.to_pandas()) == list(want)
    for closed in ("left", "right", "both", "neither"):
        a_r = RI.interval_range(0.0, 10.0, periods=5, closed=closed)
        b_r = RI.interval_range(2.0, 12.0, periods=5, closed="right")
        a_t = TI.interval_range(0.0, 10.0, periods=5, closed=closed, device="cpu")
        b_t = TI.interval_range(2.0, 12.0, periods=5, closed="right", device="cpu")
        np.testing.assert_array_equal(a_t.overlaps(b_t).to_numpy(), a_r.overlaps(b_r).to_numpy())
