"""The port's DataFrame and Series (``cudf_tpu_torch/frame``) against
cudf_tpu's, case by case.

Each case is one function over a namespace ``P`` that builds frames and
Series: the reference's (``cudf_tpu``), the port's on the CPU, and plain
pandas. The same pandas inputs, made from a seed, go through all three.
The port must equal the reference (keys, row order, index and null masks
exactly, floats at rtol 1e-12) and, where the case is pandas code too,
pandas (floats at rtol 1e-12). Where the reference differs from pandas the
case says so and pins the reference's answer. The cases mirror
tests/test_dataframe.py, tests/test_index.py and tests/test_api_longtail.py.
"""
import io as _io

import jax
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct

import cudf_tpu_torch as tt
from cudf_tpu_torch.io import read_parquet as t_io_read_parquet


class NS:
    """Builds frames and Series in one package."""

    def __init__(self, name):
        self.name = name

    def df(self, pdf):
        if self.name == "pandas":
            return pdf.copy()
        if self.name == "ref":
            return ct.DataFrame.from_pandas(pdf)
        return tt.DataFrame.from_pandas(pdf, device="cpu")

    def s(self, data):
        if self.name == "pandas":
            return pd.Series(data)
        if self.name == "ref":
            return ct.Series(data)
        return tt.Series(data, device="cpu")

    def dict_df(self, d):
        if self.name == "pandas":
            return pd.DataFrame(d)
        if self.name == "ref":
            return ct.DataFrame(d)
        return tt.DataFrame(d, device="cpu")

    def concat(self, objs, **kw):
        if self.name == "pandas":
            return pd.concat(objs, ignore_index=True, **kw)
        return (ct if self.name == "ref" else tt).concat(objs, **kw)


REF, PORT, PANDAS = NS("ref"), NS("port"), NS("pandas")


def _sdf():  # tests/test_api_longtail.py's frame
    rng = np.random.default_rng(0)
    return pd.DataFrame({"a": rng.integers(0, 10, 200).astype(np.int64),
                         "b": rng.normal(size=200),
                         "c": rng.integers(0, 3, 200).astype(np.float64)})


def _idf():  # tests/test_index.py's frame
    return pd.DataFrame({"a": [3, 1, 2, 5, 4], "b": [1.0, np.nan, 3.0, 4.0, 5.0],
                         "k": ["x", "y", "x", "y", "x"]},
                        index=pd.Index([10, 11, 12, 13, 14], name="rid"))


def _nulls():
    rng = np.random.default_rng(7)
    n = 300
    b = rng.normal(size=n)
    b[rng.random(n) < 0.1] = np.nan
    k = pd.array(rng.integers(0, 5, n), dtype="Int64")
    k[rng.random(n) < 0.05] = pd.NA
    return pd.DataFrame({"k": k, "b": b,
                         "s": rng.choice(["p", "q", "r", None], n).astype(object),
                         "t": pd.Timestamp("2021-03-01")
                         + pd.to_timedelta(rng.integers(0, 10**6, n), unit="min")})


SDF, IDF, NDF = _sdf(), _idf(), _nulls()
L = pd.DataFrame({"k": [1, 2, 3, 2], "a": [1.0, 2.0, 3.0, 4.0]})
R = pd.DataFrame({"k": [2, 3, 4], "b": [20.0, 30.0, 40.0]})
MA = pd.DataFrame({"k1": ["a", "a", "b", "b", "c"], "k2": [1, 2, 1, 2, 1],
                   "v": [1.0, 2, 3, 4, 5]}).set_index(["k1", "k2"])
MB = pd.DataFrame({"k1": ["b", "a", "a", "d"], "k2": [1, 2, 3, 1],
                   "w": [10.0, 20, 30, 40]}).set_index(["k1", "k2"])

# name -> (case, mode): "both" holds the port against the reference and
# pandas, "ref" against the reference only (the case is not pandas code),
# "pandas" against pandas where the reference differs from it: the
# reference's answer is pinned as different (a fault of the reference).
CASES = {
    # ---- tests/test_dataframe.py
    "construct_dict": (lambda P: P.dict_df({"a": [1, 2, 3], "b": [1.5, None, 3.5]}), "both"),
    "getitem_series": (lambda P: P.df(SDF)["a"], "both"),
    "setitem": (lambda P: _setitem(P), "both"),
    "boolean_mask": (lambda P: (lambda d: d[d["a"] > 2])(P.df(SDF)), "both"),
    "attribute": (lambda P: P.df(SDF).a, "both"),
    "head_tail_slice": (lambda P: (P.df(SDF).head(3), P.df(SDF).tail(2), P.df(SDF)[2:5]),
                        "pandas"),
    "arith": (lambda P: (P.s([1.0, 2.0, 3.0]) + 1) * 2 / 4 - 0.5, "both"),
    "reductions": (lambda P: [getattr(P.s([1.0, 2.0, np.nan, 4.0]), m)()
                              for m in ("sum", "mean", "count", "max", "min", "std",
                                        "var", "median")], "both"),
    "fillna": (lambda P: P.s([1.0, np.nan, 3.0]).fillna(0), "both"),
    "value_counts": (lambda P: P.s([1, 2, 2, 3, 3, 3]).value_counts(), "both"),
    "cumsum": (lambda P: P.df(SDF).cumsum(), "both"),
    "unique_nunique": (lambda P: (np.sort(P.s([3, 1, 3, 2]).unique().to_numpy()
                                          if P.name != "pandas"
                                          else np.sort(pd.Series([3, 1, 3, 2]).unique())),
                                  P.s([3, 1, 3, 2, np.nan]).nunique()), "pandas"),
    "str_accessor": (lambda P: (P.s(["Foo", "bar", None]).str.lower(),
                                P.s(["Foo", "bar", None]).str.contains("o", regex=False)),
                     "ref"),
    "dt_accessor": (lambda P: [getattr(P.s(NDF["t"]).dt, f)
                               for f in ("year", "month", "day", "hour", "minute",
                                         "second", "weekday")], "both"),
    "dt_dayofyear": (lambda P: P.s(NDF["t"]).dt.dayofyear, "pandas"),
    "isin_between": (lambda P: (P.s([1, 2, 3, 4]).isin([2, 4]),
                                P.s([1, 2, 3, 4]).between(2, 3)), "both"),
    "sort_values": (lambda P: (P.df(SDF).sort_values("a", kind="stable"),
                               P.df(SDF).sort_values(["c", "a"], ascending=False,
                                                     kind="stable")), "both"),
    "sort_values_nan_keys": (lambda P: P.df(NDF[["b", "k"]]).sort_values(
        "b", kind="stable", na_position="first"), "both"),
    "dropna": (lambda P: (P.df(NDF).dropna(), P.df(NDF).dropna(subset=["b"]),
                          P.df(NDF).dropna(how="all"), P.df(NDF).dropna(thresh=3)), "both"),
    "drop_duplicates": (lambda P: P.df(SDF[["a", "c"]]).drop_duplicates(), "pandas"),
    "merge": (lambda P: [P.df(L).merge(P.df(R), on="k", how=h)
                         for h in ("inner", "left")], "both"),
    "merge_outer_right": (lambda P: [P.df(L).merge(P.df(R), on="k", how=h)
                                     for h in ("outer", "right")], "ref"),
    "merge_semi_anti_cross": (lambda P: [P.df(L).merge(P.df(R), on="k", how=h)
                                         for h in ("leftsemi", "leftanti", "cross")],
                              "ref"),
    "concat": (lambda P: (P.concat([P.df(L), P.df(L)]),
                          P.concat([P.s([1, 2]), P.s([3])])), "both"),
    "query": (lambda P: P.df(SDF).query("(a > 1) & (b < 0.5)"), "pandas"),
    "astype": (lambda P: P.df(SDF).astype({"b": "int32", "a": "float32"}), "both"),
    "nlargest": (lambda P: (P.df(SDF).nlargest(5, "b"), P.df(SDF).nsmallest(5, "b")),
                 "both"),
    # ---- tests/test_index.py
    "index_roundtrip": (lambda P: P.df(IDF), "both"),
    "index_sort_filter_head": (lambda P: (lambda d: (d.sort_values("a"), d[d["a"] > 2],
                                                     d.head(3), d.tail(2)))(P.df(IDF)),
                               "both"),
    "index_dropna": (lambda P: P.df(IDF).dropna(), "both"),
    "set_reset_index": (lambda P: (lambda d: (d.set_index("k"),
                                              d.set_index("k").reset_index()))(
        P.df(IDF.reset_index(drop=True))), "both"),
    "sort_index": (lambda P: P.df(IDF.sort_values("a")).sort_index(), "both"),
    "loc": (lambda P: (lambda d: (d.loc[[11, 13]], d.loc[d["a"] > 3]))(P.df(IDF)), "both"),
    "series_index": (lambda P: (lambda s: (s, s.sort_values(),
                                           s.sort_values().sort_index()))(P.df(IDF)["a"]),
                     "both"),
    "series_dropna_index": (lambda P: P.s(pd.Series([1.0, np.nan, 3.0],
                                                    index=pd.Index(["p", "q", "r"])))
                            .dropna(), "both"),
    "iloc": (lambda P: (P.df(IDF).iloc[[0, 2, 4]], P.df(IDF).iloc[1:4]), "both"),
    "iloc_default_index": (lambda P: (P.df(SDF).iloc[[0, 5, 9]], P.df(SDF).take([3, 1])),
                           "pandas"),
    "drop_duplicates_index": (lambda P: P.df(pd.DataFrame(
        {"a": [1, 1, 2]}, index=pd.Index([5, 6, 7], name="i"))).drop_duplicates(
        subset=["a"]).sort_index(), "both"),
    "loc_multiindex": (lambda P: (lambda d: (d.loc["a"], d.loc[("b", 2)]))(
        P.df(pd.DataFrame({"k1": ["a", "a", "b", "b"], "k2": [1, 2, 1, 2],
                           "v": [10., 20, 30, 40]})).set_index(["k1", "k2"])), "ref"),
    # ---- tests/test_api_longtail.py
    "series_named_binops": (lambda P: [getattr(P.s(SDF["b"]), m)(2.0)
                                       for m in ("add", "sub", "mul", "truediv", "floordiv",
                                                 "mod", "pow", "radd", "rsub", "rmul",
                                                 "rtruediv", "eq", "ne", "lt", "le", "gt",
                                                 "ge")], "both"),
    "series_where_mask_clip": (lambda P: (lambda s: (s.where(s > 0, 0.0), s.mask(s > 0, 0.0),
                                                     s.clip(-0.5, 0.5)))(P.s(SDF["b"])),
                               "both"),
    "series_isin_map": (lambda P: (lambda s: (s.isin([1, 3, 5]),
                                              s.map({i: i * 10 for i in range(10)})))(
        P.s(SDF["a"])), "both"),
    "series_take_iloc": (lambda P: (lambda s: (s.take([5, 1, 7, 199]), s.iloc[5:20],
                                               s.iloc[[3, 9, 12]], s.tail(3)))(P.s(SDF["a"])),
                         "pandas"),
    "series_idx_mode_dups": (lambda P: (lambda s, sa: (
        s.idxmax(), s.idxmin(), sa.mode(), sa.duplicated(), sa.drop_duplicates(),
        sa.nlargest(7), sa.nsmallest(7)))(P.s(SDF["b"]), P.s(SDF["a"])), "ref"),
    "series_stats": (lambda P: (lambda s, s2: (s.skew(), s.kurt(), s.sem(), s.corr(s2),
                                               s.cov(s2), s.combine_first(s2)))(
        P.s(NDF["b"]), P.s(SDF["c"].iloc[:300 - 100].reindex(range(300)))), "both"),
    "series_describe_moments": (lambda P: (
        P.s(NDF["b"].to_numpy()).describe(),
        P.s(["x", "y", None, "y", "z", "x", "y"]).describe(),
        P.s(NDF["b"].astype(np.float32)).skew(), P.s(NDF["b"].astype(np.float32)).kurt(),
        P.s(NDF["k"]).skew(), P.s([1.0, 1.0, 1.0, 1.0]).kurt(), P.s([1.0, 2.0]).skew()),
                                "both"),
    "series_describe_keeps_name": (lambda P: P.s(NDF["b"]).describe(), "pandas"),
    "frame_corr": (lambda P: P.df(NDF[["k", "b"]].assign(c=SDF["c"].iloc[:300 - 100]
                                                           .reindex(range(300)))).corr(),
                   "both"),
    "series_repeat_counts": (lambda P: P.s(["a", None, "b"]).repeat([1, 3, 0]), "ref"),
    "frame_value_counts": (lambda P: (P.df(SDF).value_counts(["a", "c"]).sort_index(),
                                      P.df(SDF).value_counts("a").sort_index()), "both"),
    "series_misc": (lambda P: (lambda s: (s.to_list(), s.to_dict(), s.to_frame("x"),
                                          s.repeat(2), s.rename("z").name))(P.s(SDF["a"])),
                    "ref"),
    "frame_named_binops": (lambda P: (lambda d: (d.add(1.0), d.mul(2.0), d.sub(d),
                                                 d.ge(0.0), d + d))(P.df(SDF)), "ref"),
    "frame_cum_and_reductions": (lambda P: (lambda d: (
        d.cumsum(), d.cummax(), d.std(), d.var(), d.median(), d.prod(), d.nunique(),
        d.quantile(0.25), d.sum(), d.mean(), d.min(), d.max(), d.count()))(P.df(SDF)),
                                 "ref"),
    "frame_where_isin_rank": (lambda P: (lambda d: (
        d.where(d.gt(0.0), 0.0), d.isin([1.0, 2.0]), d.rank(), d.diff(), d.shift(2),
        d.abs(), d.round(2), d.clip(0.0, 5.0)))(P.df(SDF)), "ref"),
    "frame_dups": (lambda P: (lambda d: (d.duplicated(subset=["a"]), d.size, d.empty))(
        P.df(SDF)), "both"),
    "frame_melt_value_counts": (lambda P: (lambda d: (
        d.melt(id_vars="a", value_vars=["b", "c"]),
        d.pivot_table(values="b", index="a", columns="c", aggfunc="mean")))(P.df(SDF)),
                                "ref"),
    "frame_filter_replace_reindex": (lambda P: (lambda d: (
        list(d.filter(items=["a", "c"]).columns), list(d.filter(regex="^[ab]$").columns),
        d.replace({1: 100}), d.reindex(columns=["a", "zz"])))(P.df(SDF)), "ref"),
    "frame_agg_apply_eval": (lambda P: (lambda d: (
        d.agg({"a": "sum", "b": "mean"}), d.apply(lambda s: s.sum()),
        d.eval("a + b * 2")))(P.df(SDF)), "ref"),
    "frame_io_conveniences": (lambda P: (lambda d: (
        pd.DataFrame(d.to_dict("list")), d.ffill(), d.bfill(),
        P.df(SDF[["a"]]).squeeze(), P.df(SDF[["a", "c"]].head(4)).T.shape))(P.df(NDF)),
                              "ref"),
    "frame_join": (lambda P: P.df(IDF[["a"]]).join(P.df(IDF[["b"]]), how="left"), "ref"),
    "frame_join_multiindex": (lambda P: [P.df(MA).join(P.df(MB), how=h)
                                         for h in ("left", "inner", "outer", "right")],
                              "both"),
    "frame_transpose": (lambda P: P.df(SDF[["a", "c"]].head(4)).transpose(), "ref"),
    "frame_isna_fillna": (lambda P: (lambda d: (d.isna(), d.notna(),
                                                d.fillna({"b": 0.0, "k": -1})))(
        P.df(NDF[["k", "b"]])), "both"),
}


def _setitem(P):
    d = P.df(SDF.head(5))
    d["x"] = d["a"] * 2
    d["y"] = 7
    d["z"] = np.arange(5.0)
    return d


def _host(x):
    """A result in pandas or numpy form."""
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if hasattr(x, "to_pandas"):
        return x.to_pandas()
    return x


def _plain(x):
    """pandas' nullable and string extension columns as the port exports
    them: numbers as float64 with NaN for a null, strings as objects."""
    if isinstance(x, pd.DataFrame):
        return pd.DataFrame({c: _plain(x[c]) for c in x.columns}, index=x.index)
    if x.dtype == object:
        try:
            return x.astype("float64")  # integers with nulls
        except (TypeError, ValueError):
            return x
    if pd.api.types.is_extension_array_dtype(x.dtype):
        return x.astype("float64" if pd.api.types.is_numeric_dtype(x.dtype) else object)
    return x


def assert_same(got, want, exact_types=True):
    """Frames, Series, arrays and scalars equal: non-floats exactly, floats
    at rtol 1e-12, NaN where the other has NaN. Without ``exact_types``
    (against pandas) dtypes may differ and nulls compare as NaN."""
    if not exact_types and isinstance(want, (pd.DataFrame, pd.Series)):
        got, want = _plain(got), _plain(want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, exact_types)
        return
    kw = dict(check_exact=False, rtol=1e-12, atol=0)
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_dtype=exact_types,
                                      check_index_type=exact_types,
                                      check_column_type=exact_types, **kw)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want, check_dtype=exact_types,
                                       check_index_type=exact_types, **kw)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        assert got == want, (got, want)


# Cases that run the reference's fills on a string column: its jitted fills
# keep the dictionary of their first trace at a shape (pinned in
# test_torch_filling.py), so these start from a fresh trace.
_FRESH_TRACE = {"frame_io_conveniences"}


@pytest.mark.parametrize("name", list(CASES))
def test_frame_case_matches_reference_and_pandas(name):
    case, mode = CASES[name]
    got = _host(case(PORT))
    if name in _FRESH_TRACE:
        jax.clear_caches()
    if mode in ("both", "pandas"):
        assert_same(got, _host(case(PANDAS)), exact_types=False)
    if mode in ("both", "ref"):
        assert_same(got, _host(case(REF)))
    else:  # the reference's fault, pinned: its answer is not pandas'
        with pytest.raises(AssertionError):
            assert_same(_host(case(REF)), _host(case(PANDAS)), exact_types=False)


# ------------------------------------------------------------- groupby (frame)
def test_readme_flow_matches_reference_and_pandas():
    """tests/test_dataframe.py::test_readme_flow, and the README's own
    quick start (keys as the index)."""
    rng = np.random.default_rng(1)
    pdf = pd.DataFrame({"a": rng.integers(0, 10, 500).astype(float),
                        "b": rng.integers(0, 3, 500),
                        "c": rng.normal(size=500)})
    pdf.loc[rng.choice(500, 30, replace=False), "a"] = np.nan
    for as_index in (False, True):
        def run(P):
            return (P.df(pdf).dropna().groupby(["a", "b"], as_index=as_index)
                    .agg(c=("c", "mean")))
        got = _host(run(PORT))
        assert_same(got, _host(run(REF)))
        assert_same(got, run(PANDAS), exact_types=False)


# ------------------------------------------------------------------- io
def test_top_level_readers_return_frames(tmp_path):
    """ctt.read_parquet/read_csv/read_json/read_orc return a DataFrame equal
    to the reference's; tests/test_dataframe.py::TestIO."""
    pdf = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", None], "c": [1.5, np.nan, 2.5]})
    p = str(tmp_path / "t.parquet")
    pdf.to_parquet(p)
    got = tt.read_parquet(p, device="cpu")
    assert isinstance(got, tt.DataFrame)
    pd.testing.assert_frame_equal(got.to_pandas(), ct.read_parquet(p).to_pandas())
    pd.testing.assert_frame_equal(got.to_pandas(), pdf)
    p2 = str(tmp_path / "out.parquet")
    got.to_parquet(p2)
    pd.testing.assert_frame_equal(pd.read_parquet(p2), pdf)
    num = pdf[["a", "c"]]
    num.to_csv(str(tmp_path / "t.csv"), index=False)
    num.to_json(str(tmp_path / "t.json"), orient="records", lines=True)
    import pyarrow as pa
    import pyarrow.orc as porc

    porc.write_table(pa.Table.from_pandas(num, preserve_index=False), str(tmp_path / "t.orc"))
    for fn, ext in (("read_csv", "csv"), ("read_json", "json"), ("read_orc", "orc")):
        path = str(tmp_path / f"t.{ext}")
        got = getattr(tt, fn)(path, device="cpu")
        assert isinstance(got, tt.DataFrame)
        pd.testing.assert_frame_equal(got.to_pandas(), getattr(ct, fn)(path).to_pandas())


def test_frame_over_parquet_decodes_only_what_it_reads(tmp_path):
    """A DataFrame keeps the deferred contract of io.read_parquet:
    ``read_parquet(p)["v"]`` decodes only v, and len, columns and dtypes
    decode nothing."""
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"k": rng.integers(0, 50, 5000),
                        "v": rng.normal(size=5000).astype(np.float32),
                        "w": rng.normal(size=5000).astype(np.float32),
                        "s": rng.choice(["a", "b"], 5000)})
    p = str(tmp_path / "scan.parquet")
    pdf.to_parquet(p)
    df = tt.read_parquet(p, device="cpu")
    assert len(df) == 5000 and list(df.columns) == ["k", "v", "w", "s"]
    pd.testing.assert_series_equal(df.dtypes, ct.read_parquet(p).dtypes)
    assert df.table.undecoded() == ["k", "v", "w", "s"]
    assert df["v"].sum() == pytest.approx(float(pdf["v"].sum()), rel=1e-5)
    assert df.table.undecoded() == ["k", "w", "s"]
    out = df[["k", "v"]].dropna().groupby("k").agg(m=("v", "mean")).to_pandas()
    assert df.table.undecoded() == ["w", "s"]
    want = pdf.groupby("k").agg(m=("v", "mean"))
    np.testing.assert_allclose(out["m"].to_numpy(), want["m"].to_numpy(), rtol=1e-6)
    # a literal in a query takes the frame's device without decoding
    q = tt.read_parquet(p, device="cpu").query("k > 10")
    assert len(q) == int((pdf.k > 10).sum())
    assert t_io_read_parquet(p, device="cpu").undecoded() == ["k", "v", "w", "s"]


# ---------------------------------------------------------- the boundaries
def test_frame_entry_points_default_to_cuda():
    pdf = pd.DataFrame({"a": [1, 2]})
    calls = [lambda: tt.DataFrame({"a": [1, 2]}), lambda: tt.DataFrame(pdf),
             lambda: tt.DataFrame.from_pandas(pdf), lambda: tt.from_pandas(pdf),
             lambda: tt.from_pandas(pdf["a"]), lambda: tt.Series([1, 2])]
    for call in calls:
        if __import__("torch").cuda.is_available():
            out = call()
            assert out.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    assert tt.from_pandas(pdf["a"], device="cpu").device.type == "cpu"
    assert tt.from_pandas(pdf, device="cpu").device.type == "cpu"


def test_unported_frame_methods_name_their_roadmap_item():
    """The frame methods that raised until the nested-types slice run and
    follow pandas; a Series of Decimal objects, which raised until the
    decimals' slice, is the reference's string Series."""
    import decimal
    import hashlib

    df = tt.DataFrame({"s": ["a b", "c"]}, device="cpu")
    assert df["s"].str.split(" ").to_pandas().tolist() == [["a", "b"], ["c"]]
    assert list(df.hash_values("md5").to_pandas()) == [
        hashlib.md5(v.encode()).hexdigest() for v in ("a b", "c")]
    pd.testing.assert_frame_equal(df.explode("s").to_pandas(), df.to_pandas())
    dec = pd.Series([decimal.Decimal("1.5"), None], dtype=object)
    pd.testing.assert_series_equal(tt.Series(dec, device="cpu").to_pandas(),
                                   ct.Series(dec).to_pandas())


def test_dataframe_proxy_builds_the_frame_of_a_table():
    from cudf_tpu.frame.series import DataFrameProxy as RProxy
    from cudf_tpu_torch.frame.series import DataFrameProxy as TProxy

    df = pd.DataFrame({"k": [3, 1, 2], "s": ["x", None, "y"]})
    got = TProxy(tt.Table.from_pandas(df, device="cpu"))
    want = RProxy(ct.Table.from_pandas(df))
    assert isinstance(got, tt.DataFrame)
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())
    pd.testing.assert_frame_equal(got.to_pandas(), df)


def test_join_of_multiindex_with_other_levels_raises():
    """A MultiIndex joins only a MultiIndex with the same named levels; the
    frames never go through pandas to do otherwise."""
    flat = tt.DataFrame.from_pandas(IDF[["a"]], device="cpu")
    multi = tt.DataFrame.from_pandas(MA, device="cpu")
    renamed = tt.DataFrame.from_pandas(MB.rename_axis(["x", "k2"]), device="cpu")
    for a, b in ((multi, flat), (flat, multi), (multi, renamed)):
        with pytest.raises(NotImplementedError, match="same named levels"):
            a.join(b)


def test_frame_info_lists_columns():
    buf = _io.StringIO()
    tt.DataFrame.from_pandas(SDF, device="cpu").info(buf=buf)
    assert "200 rows" in buf.getvalue() and "b: float64" in buf.getvalue()


def test_filter_column_and_drop_nans_match_reference():
    """The two compaction helpers the frame needs
    (``stream_compaction.filter_column`` and ``drop_nans``)."""
    from cudf_tpu.ops import stream_compaction as rsc

    from cudf_tpu_torch.ops import stream_compaction as tsc

    r = ct.Table.from_pandas(NDF)
    t = tt.Table.from_pandas(NDF, device="cpu")
    rm = ct.Series(NDF["b"] > 0)._col
    tm = tt.Series(NDF["b"] > 0, device="cpu")._col
    for name in ("k", "s", "t"):
        pd.testing.assert_series_equal(tsc.filter_column(t[name], tm).to_pandas(),
                                       rsc.filter_column(r[name], rm).to_pandas())
    pd.testing.assert_frame_equal(tsc.drop_nans(t, ["b"]).to_pandas(),
                                  rsc.drop_nans(r, ["b"]).to_pandas())
    pd.testing.assert_frame_equal(tsc.drop_nans(t).to_pandas(), rsc.drop_nans(r).to_pandas())
