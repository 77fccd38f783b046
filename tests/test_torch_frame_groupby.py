"""The port's DataFrame.groupby (``cudf_tpu_torch/frame/groupby.py``)
against cudf_tpu's and pandas.

The same pandas frames, made from a seed, go through the reference, the
port on the CPU and pandas: every aggregation, named and dict
aggregations, ``as_index``, ``dropna``, a selected column, all-null and
all-NaN groups, and the grouped window methods. Keys, counts, group order,
index and null masks are exact; f64 aggregates rtol 1e-12 against the
reference (both take a sort lane), f32 sums rtol 1e-5. A spy shows that
the README's groupby on an f32 column with NaNs reaches the one-hot kernel
lane (``fastgroup._onehot_groupby``) through the frame.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct

import cudf_tpu_torch as tt
from cudf_tpu_torch.kernels import onehot_groupby as tkernel
from cudf_tpu_torch.ops import fastgroup as tfast


def _frame(seed=0, n=400):
    """Keys with nulls, an f64 value with NaNs and a group of only NaN
    (k == 5), an int value and an f32 value with NaNs."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n)
    v = rng.normal(size=n)
    v[rng.random(n) < 0.1] = np.nan
    v[k == 5] = np.nan
    w = rng.integers(-50, 50, n)
    f = rng.normal(size=n).astype(np.float32)
    f[rng.random(n) < 0.1] = np.nan
    f[k == 5] = np.nan
    kn = pd.array(k, dtype="Int64")
    kn[rng.random(n) < 0.05] = pd.NA
    return pd.DataFrame({"k": k, "kn": kn, "k2": rng.integers(0, 3, n), "v": v, "w": w,
                         "f": f})


PDF = _frame()


def _build(pkg, pdf):
    if pkg == "ref":
        return ct.DataFrame.from_pandas(pdf)
    if pkg == "port":
        return tt.DataFrame.from_pandas(pdf, device="cpu")
    return pdf.copy()


def _host(x):
    return x.to_pandas() if hasattr(x, "to_pandas") else x


def _plain(x):
    """pandas' nullable columns as the port exports them (float64, NaN)."""
    if isinstance(x, pd.DataFrame):
        return pd.DataFrame({c: _plain(x[c]) for c in x.columns}, index=_plain_index(x.index))
    if pd.api.types.is_extension_array_dtype(x.dtype) or x.dtype == object:
        x = x.astype("float64")
    return pd.Series(x.to_numpy(), index=_plain_index(x.index), name=x.name)


def _plain_index(ix):
    if isinstance(ix, pd.MultiIndex):
        return pd.MultiIndex.from_arrays([np.asarray(ix.get_level_values(i), np.float64)
                                          for i in range(ix.nlevels)], names=ix.names)
    return pd.Index(np.asarray(ix, np.float64), name=ix.name)


def check(run, rtol=1e-12, vs_pandas=True):
    """The port equals the reference exactly in types, and pandas in values."""
    got = _host(run("port"))
    want = _host(run("ref"))
    kw = dict(check_exact=False, rtol=rtol, atol=0)
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, **kw)
    else:
        pd.testing.assert_series_equal(got, want, **kw)
    if vs_pandas:
        p = run("pandas")
        if isinstance(p, pd.DataFrame):
            pd.testing.assert_frame_equal(_plain(got), _plain(p), check_dtype=False, **kw)
        else:
            pd.testing.assert_series_equal(_plain(got), _plain(p), check_dtype=False, **kw)


METHODS = ["sum", "mean", "min", "max", "count", "nunique", "var", "std",
           "median", "first", "last", "product"]


@pytest.mark.parametrize("as_index", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_every_method(method, as_index):
    cols = ["k", "v", "w"]

    def run(pkg):
        g = _build(pkg, PDF[cols]).groupby("k", as_index=as_index)
        return getattr(g, "prod" if pkg == "pandas" and method == "product" else method)()
    check(run)


@pytest.mark.parametrize("as_index", [True, False])
def test_size_equals_pandas(as_index):
    """The reference's generated ``size`` calls itself; the port's equals
    pandas (a Series by key, or a frame with a "size" column)."""
    with pytest.raises(RecursionError):
        _build("ref", PDF).groupby("k", as_index=as_index).size()
    got = _host(_build("port", PDF).groupby("k", as_index=as_index).size())
    want = PDF.groupby("k", as_index=as_index).size()
    if as_index:
        want = want.to_frame("size")  # the reference's shape: one column
    pd.testing.assert_frame_equal(got, want, check_index_type=False)


@pytest.mark.parametrize("keys", [["k"], ["k", "k2"], ["kn"]])
@pytest.mark.parametrize("as_index", [True, False])
def test_named_aggregations(keys, as_index):
    def run(pkg):
        return _build(pkg, PDF).groupby(keys, as_index=as_index).agg(
            s=("v", "sum"), m=("v", "mean"), n=("v", "count"), z=("v", "size"),
            lo=("w", "min"), hi=("w", "max"), fs=("f", "sum"))
    check(run, rtol=1e-5)  # fs: an f32 sum


def test_dict_aggregation_and_selection():
    def run(pkg):
        return _build(pkg, PDF).groupby("k").agg({"v": "sum", "w": "mean"})
    check(run)

    def sel(pkg):
        return _build(pkg, PDF).groupby("k")["v"].mean()
    check(sel)

    def many(pkg):  # a list per column: the reference names them col_how
        return _build(pkg, PDF).groupby("k").agg({"v": ["sum", "max"]})
    check(many, vs_pandas=False)


def test_null_keys_kept_with_dropna_false():
    def run(pkg):
        return _build(pkg, PDF).groupby("kn", dropna=False).agg(s=("v", "sum"),
                                                                n=("v", "size"))
    check(run)


def test_all_nan_group_sums_to_zero():
    """k == 5 holds only NaN: pandas' sum is 0 (min_count=0), its mean NaN,
    its count 0 and its size the group's rows."""
    def run(pkg):
        return _build(pkg, PDF).groupby("k").agg(s=("v", "sum"), m=("v", "mean"),
                                                 c=("v", "count"), z=("v", "size"))
    check(run)
    got = _build("port", PDF).groupby("k").agg(s=("v", "sum"), m=("v", "mean")).to_pandas()
    assert got.loc[5, "s"] == 0 and np.isnan(got.loc[5, "m"])


def test_frame_groupby_reaches_the_onehot_lane(monkeypatch):
    """The README's groupby through the frame on an f32 column with NaNs,
    one group all NaN: the frame turns NaN into nulls, and the one-hot
    lane takes the column with its mask (V = 2): valid sum, valid count,
    row count. The answer equals pandas, the all-NaN group included."""
    calls, shapes = [], []
    inner = tfast._onehot_groupby
    monkeypatch.setattr(tfast, "_onehot_groupby",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    inner_k = tkernel.groupby_sum_count_plain
    monkeypatch.setattr(tkernel, "groupby_sum_count_plain",
                        lambda g, v, w, K: shapes.append(v.shape[1]) or inner_k(g, v, w, K))
    pdf = PDF[["k", "k2", "f"]]
    got = (tt.from_pandas(pdf, device="cpu").dropna(subset=["k"])
           .groupby(["k", "k2"]).agg(avg=("f", "mean"), s=("f", "sum"), n=("f", "size"),
                                      c=("f", "count"))).to_pandas()
    assert calls == [1] and shapes == [2]
    want = pdf.dropna(subset=["k"]).groupby(["k", "k2"]).agg(
        avg=("f", "mean"), s=("f", "sum"), n=("f", "size"), c=("f", "count"))
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(got["n"].to_numpy(), want["n"].to_numpy())
    np.testing.assert_array_equal(got["c"].to_numpy(), want["c"].to_numpy())
    np.testing.assert_allclose(got["avg"].to_numpy(), want["avg"].to_numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["s"].to_numpy(), want["s"].to_numpy(), rtol=1e-5)
    assert (got.loc[5, "s"] == 0).all() and got.loc[5, "avg"].isna().all()


def test_dropna_then_groupby_takes_the_onehot_lane_at_one_value_column(monkeypatch):
    """The README quick start: after dropna() no value is NaN or null, so the
    f32 column reaches the one-hot kernel as itself (V = 1), not as a
    masked pair, and the answer equals pandas."""
    shapes = []
    inner_k = tkernel.groupby_sum_count_plain
    monkeypatch.setattr(tkernel, "groupby_sum_count_plain",
                        lambda g, v, w, K: shapes.append(v.shape[1]) or inner_k(g, v, w, K))
    pdf = PDF[["k", "k2", "f"]]
    got = (tt.from_pandas(pdf, device="cpu").dropna().groupby(["k", "k2"])
           .agg(avg=("f", "mean"), s=("f", "sum"), n=("f", "size"))).to_pandas()
    assert shapes == [1]
    want = pdf.dropna().groupby(["k", "k2"]).agg(avg=("f", "mean"), s=("f", "sum"),
                                                 n=("f", "size"))
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(got["n"].to_numpy(), want["n"].to_numpy())
    np.testing.assert_allclose(got["avg"].to_numpy(), want["avg"].to_numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["s"].to_numpy(), want["s"].to_numpy(), rtol=1e-5)


def test_sort_false_is_refused():
    for pkg in ("ref", "port"):
        with pytest.raises(NotImplementedError):
            _build(pkg, PDF).groupby("k", sort=False).sum()


# ------------------------------------------------------- grouped windows
@pytest.mark.parametrize("method", ["shift", "shift_back", "cumsum", "cumsum_nan",
                                    "cumcount", "rolling_sum", "rolling_mean",
                                    "rolling_count"])
def test_window_methods(method):
    def run(pkg):
        g = _build(pkg, PDF[["k", "v", "w"]]).groupby("k")
        if method == "shift":
            return g["w"].shift(2)
        if method == "shift_back":
            return g["v"].shift(-1)
        if method == "cumsum":
            return g["w"].cumsum()
        if method == "cumsum_nan":
            return g["v"].cumsum()
        if method == "cumcount":
            return g.cumcount()
        return g["v"].rolling_agg(3, method.split("_")[1], 1)
    got, want = _host(run("port")), _host(run("ref"))
    if method == "rolling_count":
        # the reference needs min_periods VALID values in a window; pandas
        # and the port need that many rows: a window of NaN counts 0
        nan_only = got.notna() & want.isna()
        assert nan_only.any() and (got[nan_only] == 0).all()
        want = want.where(~nan_only, 0.0)
    if method == "cumsum_nan":
        # the reference carries a NaN on through its group's running sum;
        # pandas and the port skip the NaN row
        assert got.notna().sum() > want.notna().sum()
    else:
        pd.testing.assert_series_equal(got, want, check_exact=False, rtol=1e-12)
    g = PDF[["k", "v", "w"]].groupby("k")
    p = {"shift": lambda: g["w"].shift(2), "shift_back": lambda: g["v"].shift(-1),
         "cumsum": lambda: g["w"].cumsum(), "cumsum_nan": lambda: g["v"].cumsum(),
         "cumcount": lambda: g.cumcount(),
         "rolling_sum": lambda: g["v"].rolling(3, 1).sum().droplevel(0).sort_index(),
         "rolling_mean": lambda: g["v"].rolling(3, 1).mean().droplevel(0).sort_index(),
         "rolling_count": lambda: g["v"].rolling(3, 1).count().droplevel(0).sort_index()
         }[method]()
    np.testing.assert_allclose(got.to_numpy(np.float64), p.to_numpy(np.float64),
                               rtol=1e-12)
