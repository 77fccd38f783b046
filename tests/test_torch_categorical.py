"""The port's categorical columns and dictionary ops
(``cudf_tpu_torch/core/categorical.py``, ``ops/dictionary.py``) against
cudf_tpu's and pandas.

Categoricals made from a seed go through both packages (the port on the
CPU): ingest and export with their categories, order and nulls, the
``.cat`` accessor, casts, sorts by category order, groupby on a
categorical key, and joins on categorical keys whose categories are
declared in different orders. Codes, categories, row order and null masks
are exact.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import dictionary as rdict
from cudf_tpu.ops.groupby import AggSpec as RAggSpec
from cudf_tpu.ops.groupby import groupby_aggregate as r_groupby
from cudf_tpu.ops.join import join as r_join
from cudf_tpu.ops.sorting import sort_by_key as r_sort

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import categorical as tcat
from cudf_tpu_torch.ops import dictionary as tdict
from cudf_tpu_torch.ops.groupby import AggSpec as TAggSpec
from cudf_tpu_torch.ops.groupby import groupby_aggregate as t_groupby
from cudf_tpu_torch.ops.join import join as t_join
from cudf_tpu_torch.ops.sorting import sort_by_key as t_sort

CATS = ["lo", "mid", "hi"]


def _frame(ordered=True, seed=0, n=400):
    rng = np.random.default_rng(seed)
    pc = pd.Categorical(rng.choice(CATS + [None], n), categories=CATS, ordered=ordered)
    return pd.DataFrame({"k": pc, "v": rng.normal(size=n), "i": np.arange(n)})


@pytest.mark.parametrize("ordered", [True, False])
def test_table_round_trip_keeps_categories(ordered):
    pdf = _frame(ordered)
    t = tt.Table.from_pandas(pdf, device="cpu")
    assert tcat.is_categorical(t["k"]) and tcat.ordered(t["k"]) == ordered
    pd.testing.assert_frame_equal(t.to_pandas(), pdf)
    pd.testing.assert_frame_equal(t.to_pandas(), ct.Table.from_pandas(pdf).to_pandas())
    df = tt.DataFrame.from_pandas(pdf, device="cpu")
    pd.testing.assert_frame_equal(df.to_pandas(), pdf)


def _series(pkg, data):
    return ct.Series(data) if pkg == "ref" else tt.Series(data, device="cpu")


def test_cat_accessor_matches_reference():
    pc = pd.Categorical(["b", "a", None, "c", "a"], categories=["c", "b", "a"],
                        ordered=True)
    for pkg in ("ref", "port"):
        s = _series(pkg, pd.Series(pc))
        assert s.cat.categories == ["c", "b", "a"] and s.cat.ordered
        np.testing.assert_array_equal(s.cat.codes.to_pandas().to_numpy(), pc.codes)
        pd.testing.assert_series_equal(s.to_pandas(), pd.Series(pc), check_names=False)
        s2 = s.cat.add_categories(["d"])
        assert s2.cat.categories == ["c", "b", "a", "d"]
        s3 = s2.cat.remove_categories(["b"])
        assert s3.to_pandas().isna().tolist() == [True, False, True, False, False]
        assert s.cat.rename_categories({"a": "A"}).cat.categories == ["c", "b", "A"]
        s5 = s.cat.reorder_categories(["a", "b", "c"], ordered=False)
        assert s5.cat.categories == ["a", "b", "c"] and not s5.cat.ordered
        assert s5.to_pandas().tolist()[:2] == ["b", "a"] and s5.to_pandas().isna()[2]
        assert not s.cat.as_unordered().cat.ordered
        got = s.cat.set_categories(["a", "b"]).to_pandas()
        assert got.isna().tolist() == [False, False, True, True, False]


def test_astype_category_and_back():
    for pkg in ("ref", "port"):
        s = _series(pkg, pd.Series(["x", "y", "x", "z"]))
        c = s.astype("category")
        assert c.cat.categories == ["x", "y", "z"]
        assert c.astype(str).to_pandas().tolist() == ["x", "y", "x", "z"]
        n = _series(pkg, pd.Series([3, 1, 3])).astype("category")
        assert n.cat.categories == [1, 3]
        assert n.astype("int64").to_pandas().tolist() == [3, 1, 3]


@pytest.mark.parametrize("kind", ["str_nulls", "float_nan", "int", "datetime_nat", "bool"])
def test_astype_category_of_each_dtype(kind):
    """astype("category") factorizes on the column's device and astype back
    decodes with one gather: both equal pandas and the reference."""
    data, back = {"str_nulls": (["x", None, "y", "x", "z"], str),
                  "float_nan": ([3.0, np.nan, 1.0, 3.0], "float64"),
                  "int": ([3, 1, 3], "int64"),
                  "datetime_nat": (pd.to_datetime(["2020-01-02", "2020-01-01", None]),
                                   "datetime64[ns]"),
                  "bool": ([True, False, True], "bool")}[kind]
    p = pd.Series(data)
    want = p.astype("category")
    got = _series("port", p).astype("category")
    pd.testing.assert_series_equal(got.to_pandas(), want)
    pd.testing.assert_series_equal(_series("ref", p).astype("category").to_pandas(), want)
    decoded = got.astype(back).to_pandas()
    assert decoded.isna().tolist() == p.isna().tolist()
    assert decoded[decoded.notna()].tolist() == p[p.notna()].tolist()


def test_sort_and_groupby_follow_category_order():
    pdf = _frame(True)
    r, t = ct.Table.from_pandas(pdf), tt.Table.from_pandas(pdf, device="cpu")
    got = t_sort(t, ["k"]).to_pandas()
    pd.testing.assert_frame_equal(got, r_sort(r, ["k"]).to_pandas())
    want = pdf.sort_values("k", kind="stable", na_position="last").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    got = t_groupby(t, ["k"], [TAggSpec("v", "mean", "m"), TAggSpec("", "size", "n")])
    want = r_groupby(r, ["k"], [RAggSpec("v", "mean", "m"), RAggSpec("", "size", "n")])
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas(), check_exact=False,
                                  rtol=1e-12)
    p = pdf.groupby("k", observed=True).agg(m=("v", "mean"), n=("v", "size"))
    np.testing.assert_allclose(got.to_pandas()["m"].to_numpy(), p["m"].to_numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("how", ["inner", "left", "full", "semi", "anti"])
def test_join_unifies_categories(how):
    """Right keys declare the categories in another order: the join
    compares values, not codes (tests/test_dtypes_round3.py)."""
    pdf = _frame(False)
    rng = np.random.default_rng(4)
    right = pd.DataFrame({"k": pd.Categorical(["hi", "lo", "other"],
                                              categories=["other", "hi", "lo"]),
                          "w": rng.normal(size=3)})
    r = r_join(ct.Table.from_pandas(pdf), ct.Table.from_pandas(right), ["k"], ["k"], how)
    t = t_join(tt.Table.from_pandas(pdf, device="cpu"),
               tt.Table.from_pandas(right, device="cpu"), ["k"], ["k"], how)
    if how == "full":
        # the reference concatenates the right-only rows' codes under the
        # left's categories ("other" comes back as "lo"); the port unifies
        # the categories first and keeps the values
        got = t.to_pandas()
        want = pdf.assign(k=pdf.k.astype(object)).merge(
            right.assign(k=right.k.astype(object)), on="k", how="outer")
        key = lambda d: sorted(map(str, d["k"].astype(object).where(d["k"].notna(), "")))
        assert key(got) == key(want) != key(r.to_pandas())
        return
    pd.testing.assert_frame_equal(t.to_pandas(), r.to_pandas())
    if how == "inner":
        want = pdf.assign(k=pdf.k.astype(object)).merge(
            right.assign(k=right.k.astype(object)), on="k")
        assert len(t.to_pandas()) == len(want)
        np.testing.assert_allclose(t.to_pandas()["w"].sum(), want["w"].sum(), rtol=1e-12)


def test_join_refuses_categorical_against_plain():
    pdf = _frame()
    t = tt.Table.from_pandas(pdf, device="cpu")
    plain = tt.Table.from_pandas(pd.DataFrame({"k": ["lo"]}), device="cpu")
    with pytest.raises(TypeError, match="categorical"):
        t_join(t, plain, ["k"], ["k"], "inner")


def test_dictionary_encode_decode_set_keys():
    rng = np.random.default_rng(5)
    x = rng.choice([5.0, 2.0, 9.0, -1.5], 300)
    rc, rk = rdict.encode(ct.Column.from_numpy(x))
    tc, tk = tdict.encode(tt.Column.from_numpy(x, device="cpu"))
    np.testing.assert_array_equal(tk, rk)
    np.testing.assert_array_equal(tc.to_numpy(), rc.to_numpy())
    np.testing.assert_array_equal(tdict.decode(tc, tk).to_numpy(), x)
    s = np.array(["a", "b", "c", "b", None], object)
    rs = rdict.set_keys(ct.Column.from_numpy(s, np.array([x is not None for x in s])),
                        np.array(["c", "a"]))
    ts = tdict.set_keys(tt.Column.from_numpy(s, device="cpu"), np.array(["c", "a"]))
    pd.testing.assert_series_equal(ts.to_pandas(), rs.to_pandas())
    assert ts.to_pandas().isna().tolist() == [False, True, False, True, True]
    sc, sk = tdict.encode(tt.Column.from_numpy(s, device="cpu"))
    np.testing.assert_array_equal(tdict.decode(sc, sk).to_numpy(), s)
