"""The port's expressions, IR executor, reductions, scans and the unary
and copying additions against cudf_tpu's.

Same pandas inputs, made from a seed, go through both packages (the port
on the CPU). Tolerances: integers, booleans, strings, keys and null masks
exact; float results rtol 1e-9 (the packages sum in different orders; the
JAX tests' assert_allclose default is 1e-7), f32 ones rtol 1e-5; f32
prefix sums also atol 1e-4 (a running sum of normals crosses zero, and the
two packages add in different orders); transcendental functions of an
integer rtol 1e-6 (the reference computes them in f32 before widening).
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.core import dtypes as rdt
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR
from cudf_tpu.ops import copying as rcopy
from cudf_tpu.ops import reductions as rred
from cudf_tpu.ops import unaryop as run

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import dtypes as tdt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.ops import copying as tcopy
from cudf_tpu_torch.ops import reductions as tred
from cudf_tpu_torch.ops import unaryop as tun

N = 200
PKGS = {"ref": (RE, RIR, rdt), "port": (TE, TIR, tdt)}


def _frame(n=N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n) * 10
    a[rng.random(n) < 0.05] = np.nan
    nulls = rng.random(n) < 0.1
    return pd.DataFrame({
        "a": a,
        "b": rng.uniform(0.5, 2.0, n),
        "g": rng.normal(size=n).astype(np.float32),
        "i": pd.arrays.IntegerArray(rng.integers(-3, 4, n), nulls),
        "j": rng.integers(-5, 5, n).astype(np.int32),
        "f": pd.arrays.FloatingArray(rng.normal(size=n), rng.random(n) < 0.1),
        "s": np.array(["a", "b", None, "dd"], object)[rng.integers(0, 4, n)],
        "t": np.datetime64("1995-01-01", "ns") + rng.integers(0, 1000, n).astype("timedelta64[D]"),
        "p": rng.random(n) < 0.5,
        "q": pd.arrays.BooleanArray(rng.random(n) < 0.5, rng.random(n) < 0.1),
    })


@pytest.fixture(scope="module")
def tables():
    df = _frame()
    return df, ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")


def _dt(d):
    return d.kind, d.bits, d.param


def assert_same(got, want, rtol=None, atol=0.0):
    """Two columns (port, reference): dtype, nulls, values."""
    assert _dt(got.dtype) == _dt(want.dtype), (got.dtype, want.dtype)
    g, w = got.to_pandas(), want.to_pandas()
    assert len(g) == len(w)
    gn, wn = pd.isna(g).to_numpy(), pd.isna(w).to_numpy()
    np.testing.assert_array_equal(gn, wn)
    g, w = g.to_numpy()[~gn], w.to_numpy()[~wn]
    if got.dtype.is_floating:
        tol = rtol if rtol is not None else (1e-5 if got.dtype.bits == 32 else 1e-9)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=tol,
                                   atol=atol)
    else:
        np.testing.assert_array_equal(g, w)


# expressions as functions of a package's (E, dtypes), drawn from tests/test_expr.py
EXPRS = {
    "arithmetic_chain": lambda E, D: (E.col("a") + E.col("b")) * 2 - 1,
    "comparison_and_logic": lambda E, D: (E.col("i") > E.col("j")) | (E.col("i") == 3),
    "kleene_and": lambda E, D: E.col("q") & E.col("p"),
    "ternary": lambda E, D: E.when(E.col("a") > 0).then(E.col("a")).otherwise(E.lit(0)),
    "ternary_nullable": lambda E, D: E.when(E.col("q")).then(E.col("i")).otherwise(E.col("j")),
    "is_in": lambda E, D: E.col("i").is_in([2, 4]),
    "is_in_empty": lambda E, D: E.col("j").is_in([]),
    "string_eq_literal": lambda E, D: E.col("s") == E.lit("b"),
    "literal_gt_string": lambda E, D: E.lit("b") > E.col("s"),
    "string_ne_absent": lambda E, D: E.col("s") != "zz",
    "date_lt_literal": lambda E, D: E.col("t") < E.Literal(np.datetime64("1996-03-15")),
    "date_between": lambda E, D: E.col("t").between(np.datetime64("1995-06-01"),
                                                   np.datetime64("1996-01-01")),
    "literal_minus_col": lambda E, D: 1 - E.col("b"),
    "literal_only": lambda E, D: E.lit(1) + E.lit(2),
    "nullable_plus_column": lambda E, D: E.col("i") + E.col("j") * E.col("f"),
    "mod_pow_floordiv": lambda E, D: (E.col("j") % 3) + E.col("j") ** 2
    + E.BinOp("floordiv", children=(E.col("j"), E.lit(2))),
    "float_mod_pow": lambda E, D: (E.col("a") % 1.5) + E.col("b") ** 0.5,
    "min_max_xor": lambda E, D: E.BinOp("max", children=(E.col("a"), E.col("b")))
    + E.BinOp("min", children=(E.col("j"), E.lit(0))),
    "is_null": lambda E, D: E.col("i").is_null(),
    "is_not_null": lambda E, D: E.col("f").is_not_null(),
    "is_nan": lambda E, D: E.col("a").is_nan(),
    "fill_null": lambda E, D: E.col("i").fill_null(0),
    "cast": lambda E, D: E.col("j").cast(D.float32) * 1.5,
    "neg_abs_not": lambda E, D: (-E.col("a")).abs() + (~(E.col("a") > 0)).cast(D.int64),
    "sqrt_exp": lambda E, D: E.UnaryFn("sqrt", children=(E.col("b"),))
    + E.UnaryFn("exp", children=(E.col("j"),)),
    "len": lambda E, D: E.Len(),
    "str_contains_regex": lambda E, D: E.col("s").str.contains("d+"),
    "str_contains_literal": lambda E, D: E.col("s").str.contains("d", regex=False),
    "str_startswith": lambda E, D: E.col("s").str.startswith("d"),
    "str_endswith": lambda E, D: E.col("s").str.endswith("b"),
    "str_like": lambda E, D: E.col("s").str.like("d_"),
    "str_lower_upper": lambda E, D: E.col("s").str.upper().str.lower() == E.lit("dd"),
    "str_strip": lambda E, D: E.col("s").str.strip(),
    "str_slice": lambda E, D: E.col("s").str.slice(1, 2),
    "str_len": lambda E, D: E.col("s").str.len() + 1,
    "dt_year": lambda E, D: E.col("t").dt.year(),
    "dt_month_day": lambda E, D: E.col("t").dt.month() * 100 + E.col("t").dt.day(),
    "dt_weekday": lambda E, D: E.col("t").dt.weekday(),
    "dt_hour_minute_second": lambda E, D: E.col("t").dt.hour() + E.col("t").dt.minute()
    + E.col("t").dt.second(),
    "dt_truncate_day": lambda E, D: E.col("t").dt.truncate("D"),
}
AGGS = ["sum", "mean", "min", "max", "count", "nunique", "median", "first", "last"]


@pytest.mark.parametrize("name", list(EXPRS))
def test_evaluate_matches_reference(tables, name):
    _, rt, pt = tables
    want = RE.evaluate(EXPRS[name](RE, rdt), rt)
    got = TE.evaluate(EXPRS[name](TE, tdt), pt)
    assert_same(got, want, rtol=1e-6 if name == "sqrt_exp" else None)


@pytest.mark.parametrize("kind", AGGS + ["var", "std", "quantile"])
@pytest.mark.parametrize("column", ["a", "i", "f"])
def test_aggregation_expressions_match_reference(tables, column, kind):
    _, rt, pt = tables
    if kind in ("var", "std"):
        mk = lambda E: getattr(E.col(column), kind)(ddof=1)  # noqa: E731
    elif kind == "quantile":
        mk = lambda E: E.col(column).quantile(0.3)  # noqa: E731
    else:
        mk = lambda E: getattr(E.col(column), kind)()  # noqa: E731
    assert_same(TE.evaluate(mk(TE), pt), RE.evaluate(mk(RE), rt))


def test_string_and_temporal_functions_are_not_ported_yet(tables):
    """They are ported now: the string and temporal nodes evaluate, and
    where the reference's datetime is wrong (``day_of_year``, ``truncate``
    to a month or a year; ROADMAP section 3) the port equals pandas."""
    df, _, pt = tables
    got = TE.evaluate(TE.col("s").str.startswith("a"), pt).to_numpy()
    want = df["s"].str.startswith("a").to_numpy()
    ok = df["s"].notna().to_numpy()
    np.testing.assert_array_equal(got[ok].astype(bool), want[ok].astype(bool))
    t = pd.Series(df["t"])
    for expr, want in ((TE.col("t").dt.day_of_year(), t.dt.day_of_year),
                       (TE.col("t").dt.truncate("M"), t.dt.to_period("M").dt.start_time),
                       (TE.col("t").dt.truncate("Y"), t.dt.to_period("Y").dt.start_time)):
        got = TE.evaluate(expr, pt).to_numpy()
        np.testing.assert_array_equal(got, want.to_numpy().astype(got.dtype))


REDUCE_KINDS = ["count", "size", "sum", "mean", "var", "std", "sum_of_squares", "m2",
                "min", "max", "product", "argmin", "argmax", "median", "quantile",
                "nunique", "first", "last"]


@pytest.mark.parametrize("column", ["a", "b", "g", "i", "j"])
def test_reduce_matches_reference(tables, column):
    _, rt, pt = tables
    for kind in REDUCE_KINDS:
        param = 0.25 if kind == "quantile" else (0 if kind in ("var", "std") else 0.0)
        want = rred.reduce(rt[column], kind, param)
        got = tred.reduce(pt[column], kind, param)
        assert got.length == want.length == 1, kind
        assert_same(got, want)
        assert tred.to_scalar(got) == pytest.approx(rred.to_scalar(want), rel=1e-5,
                                                    nan_ok=True), kind


def test_reduce_bool_empty_and_all_null_match_reference(tables):
    _, rt, pt = tables
    for kind in ("any", "all", "count", "sum"):
        assert_same(tred.reduce(pt["q"], kind), rred.reduce(rt["q"], kind))
    empty = pd.DataFrame({"x": np.array([], np.float64)})
    nulls = pd.DataFrame({"y": pd.arrays.IntegerArray(np.zeros(3, np.int64), np.ones(3, bool))})
    re_, pe = ct.Table.from_pandas(empty), tt.Table.from_pandas(empty, device="cpu")
    ry, py = ct.Table.from_pandas(nulls), tt.Table.from_pandas(nulls, device="cpu")
    for kind in ("sum", "mean", "min", "max", "count", "var", "any", "all"):
        assert_same(tred.reduce(pe["x"], kind), rred.reduce(re_["x"], kind))
        assert_same(tred.reduce(py["y"], kind), rred.reduce(ry["y"], kind))
        assert tred.to_scalar(tred.reduce(py["y"], kind)) == rred.to_scalar(
            rred.reduce(ry["y"], kind))


@pytest.mark.parametrize("column", ["a", "g", "i", "j"])
def test_scan_matches_reference(tables, column):
    _, rt, pt = tables
    for kind in ("cumsum", "cummax", "cummin", "cumprod", "cumcount"):
        c_r, c_p = rt[column], pt[column]
        if kind == "cumprod" and column in ("a", "g"):  # keep the product finite
            c_r, c_p = rt["b"], pt["b"]
        assert_same(tred.scan(c_p, kind), rred.scan(c_r, kind), rtol=1e-6,
                    atol=1e-4 if column == "g" else 0.0)
    for adjust in (True, False):
        assert_same(tred.ewma(pt[column], 0.3, adjust), rred.ewma(rt[column], 0.3, adjust))


UNARY = {"a": ["abs", "neg", "ceil", "floor", "rint", "tanh", "arctan", "sin", "cos"],
         "b": ["sqrt", "log", "log2", "log10", "exp", "cbrt", "arcsin", "arccos", "cosh"],
         "j": ["abs", "neg", "bit_invert", "sqrt", "exp", "ceil"], "p": ["not"]}


@pytest.mark.parametrize("column", list(UNARY))
def test_unary_op_matches_reference(tables, column):
    _, rt, pt = tables
    for op in UNARY[column]:
        c_r, c_p = rt[column], pt[column]
        if op in ("arcsin", "arccos"):  # log(b) lies in (-0.7, 0.7)
            c_r, c_p = run.unary_op(rt["b"], "log"), tun.unary_op(pt["b"], "log")
        assert_same(tun.unary_op(c_p, op), run.unary_op(c_r, op), rtol=1e-6)


def test_replace_fill_clamp_round_find_match_reference(tables):
    _, rt, pt = tables
    assert_same(tun.replace_nulls(pt["i"], 9), run.replace_nulls(rt["i"], 9))
    assert_same(tun.replace_nulls(pt["i"], pt["i"]), run.replace_nulls(rt["i"], rt["i"]))
    assert_same(tun.replace_nulls(pt["f"], pt["b"]), run.replace_nulls(rt["f"], rt["b"]))
    assert_same(tun.replace_nulls(pt["s"], "zz"), run.replace_nulls(rt["s"], "zz"))
    assert_same(tun.replace_nulls(pt["s"], "a"), run.replace_nulls(rt["s"], "a"))
    assert_same(tun.fill_nan(pt["a"], -1.0), run.fill_nan(rt["a"], -1.0))
    assert_same(tun.fill_nan(pt["j"], -1.0), run.fill_nan(rt["j"], -1.0))
    for lo, hi in ((-2.0, 3.0), (None, 0.5), (1, None)):
        assert_same(tun.clamp(pt["a"], lo, hi), run.clamp(rt["a"], lo, hi))
        assert_same(tun.clamp(pt["j"], lo, hi), run.clamp(rt["j"], lo, hi))
    for decimals in (0, 1, -1):
        for how in ("half_even", "half_up"):
            assert_same(tun.round_col(pt["a"], decimals, how),
                        run.round_col(rt["a"], decimals, how))
            assert_same(tun.round_col(pt["j"], decimals, how),
                        run.round_col(rt["j"], decimals, how))
    halves = pd.DataFrame({"h": [0.5, 1.5, 2.5, -0.5, -1.5, 0.25, 0.35]})
    rh, ph = ct.Table.from_pandas(halves), tt.Table.from_pandas(halves, device="cpu")
    for decimals in (0, 1):
        for how in ("half_even", "half_up"):
            assert_same(tun.round_col(ph["h"], decimals, how),
                        run.round_col(rh["h"], decimals, how), rtol=1e-15)
    assert_same(tun.find_and_replace(pt["j"], [1, -5, 7], [100, 200, 300]),
                run.find_and_replace(rt["j"], [1, -5, 7], [100, 200, 300]))
    assert_same(tun.find_and_replace(pt["a"], [np.nan], [0.0]),
                run.find_and_replace(rt["a"], [np.nan], [0.0]))


def test_copy_if_else_matches_reference(tables):
    _, rt, pt = tables
    for rhs_r, rhs_p in ((rt["j"], pt["j"]), (7, 7), (None, None), (np.nan, np.nan)):
        assert_same(tcopy.copy_if_else(pt["i"], rhs_p, pt["q"]),
                    rcopy.copy_if_else(rt["i"], rhs_r, rt["q"]))
    assert_same(tcopy.copy_if_else(pt["a"], np.nan, pt["p"]),
                rcopy.copy_if_else(rt["a"], np.nan, rt["p"]))
    assert_same(tcopy.copy_if_else(pt["a"], pt["b"], pt["p"]),
                rcopy.copy_if_else(rt["a"], rt["b"], rt["p"]))


# ----------------------------------------------------------------- the IR
def _scan(pkg, df):
    E, IR, _ = PKGS[pkg]
    tbl = (ct.Table.from_pandas(df) if pkg == "ref"
           else tt.Table.from_pandas(df, device="cpu"))
    return IR.DataFrameScan(tbl)


PLANS = {  # tests/test_expr.py's TestIRExecutor plans, and the other nodes
    "select_filter_sort": lambda E, IR, s: IR.Sort(("a",), (False,), (True,), children=(
        IR.Filter(E.col("a") > 1, children=(
            IR.Select((E.NamedExpr("a", E.col("a")), E.NamedExpr("ab", E.col("a") * E.col("b"))),
                      children=(s("x"),)),)),)),
    "groupby": lambda E, IR, s: IR.GroupBy(("k",), (
        E.NamedExpr("s", E.col("v").sum()), E.NamedExpr("n", E.Len()),
        E.NamedExpr("m", (E.col("v") * 2).mean())), children=(s("g"),)),
    "groupby_keyless": lambda E, IR, s: IR.GroupBy((), (
        E.NamedExpr("s", E.col("v").sum()), E.NamedExpr("x", E.col("v").max())),
        children=(s("g"),)),
    "join": lambda E, IR, s: IR.Join(("k",), ("k",), "inner", children=(s("l"), s("r"))),
    "union_distinct": lambda E, IR, s: IR.Distinct(None, "first", children=(
        IR.Union(children=(s("u1"), s("u2"))),)),
    "hstack_slice": lambda E, IR, s: IR.Slice(1, 2, children=(
        IR.HStack((E.NamedExpr("c", E.col("a") - E.col("b")),
                   E.NamedExpr("a", E.col("a") * 0)), children=(s("x"),)),)),
    "reduce_projection": lambda E, IR, s: IR.Reduce((
        E.NamedExpr("t", E.col("a").sum()), E.NamedExpr("n", E.col("b").count())),
        children=(IR.Projection(("a", "b"), children=(s("x"),)),)),
    "hconcat_rename_cache": lambda E, IR, s: IR.MapFunction("rename", (("a", "aa"),), children=(
        IR.HConcat(children=(IR.Cache(1, children=(s("x"),)), s("y"))),)),
    "merge_sorted": lambda E, IR, s: IR.MergeSorted("k", children=(s("m1"), s("m2"))),
    "shuffle_repartition": lambda E, IR, s: IR.Repartition(2, children=(
        IR.Shuffle(("k",), 2, children=(s("g"),)),)),
    "empty": lambda E, IR, s: IR.Empty(),
    "rolling": lambda E, IR, s: IR.Rolling("t", 5, (("r", "x", "sum"), ("m", "x", "max")),
                                           children=(s("w"),)),
    "rolling_range": lambda E, IR, s: IR.Rolling("t", 3, (("r", "x", "mean"),), True,
                                                 children=(s("w"),)),
    "row_index": lambda E, IR, s: IR.MapFunction("row_index", ("i",), children=(s("x"),)),
}
FRAMES = {
    "x": pd.DataFrame({"a": [3.0, 1.0, 2.0, 5.0], "b": [1.0, 2.0, 3.0, 4.0]}),
    "y": pd.DataFrame({"z": [7, 8, 9, 10]}),
    "g": pd.DataFrame({"k": np.random.default_rng(0).integers(0, 5, 100),
                       "v": np.random.default_rng(1).normal(size=100)}),
    "l": pd.DataFrame({"k": [1, 2, 3], "a": [1.0, 2.0, 3.0]}),
    "r": pd.DataFrame({"k": [2, 3, 4, 3], "b": [20.0, 30.0, 40.0, 31.0]}),
    "u1": pd.DataFrame({"x": [1, 2]}),
    "u2": pd.DataFrame({"x": [2, 3]}),
    "m1": pd.DataFrame({"k": [1, 3, 5], "v": [0, 1, 2]}),
    "m2": pd.DataFrame({"k": [2, 3, 6], "v": [10, 11, 12]}),
    "w": pd.DataFrame({"t": np.random.default_rng(2).permutation(20),
                       "x": np.r_[np.arange(19.0) ** 1.5, np.nan]}),
}


def _run(pkg, name):
    E, IR, _ = PKGS[pkg]
    return IR.execute(PLANS[name](E, IR, lambda f: _scan(pkg, FRAMES[f]))).to_pandas()


@pytest.mark.parametrize("name", list(PLANS))
def test_ir_executor_matches_reference(name):
    want, got = _run("ref", name), _run("port", name)
    if name == "join":  # ordered=False: the same rows as a multiset
        got = got.sort_values(list(got.columns)).reset_index(drop=True)
        want = want.sort_values(list(want.columns)).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)


def test_execute_with_profile_matches_execute():
    plan = PLANS["select_filter_sort"](TE, TIR, lambda f: _scan("port", FRAMES[f]))
    out, profile = TIR.execute_with_profile(plan)
    pd.testing.assert_frame_equal(out.to_pandas(), TIR.execute(plan).to_pandas())
    assert [p[0] for p in profile] == ["DataFrameScan", "Select", "Filter", "Sort"]
    assert all(s >= 0 for _, s, _ in profile) and profile[-1][2] == out.num_rows


def test_unported_nodes_name_their_roadmap_item():
    s = _scan("port", FRAMES["x"])
    cases = [(TIR.ConditionalJoin(TE.col("a") > TE.col("b"), children=(s, s)), "item 8"),
             (TIR.MapFunction("explode", ("a",), children=(s,)), "item 14")]
    for node, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            TIR.execute(node)


def test_filter_compacts_only_what_its_parent_reads(monkeypatch):
    """The pushdown drops predicate-only columns before the compaction."""
    from cudf_tpu_torch.ops import stream_compaction as sc

    seen = []
    inner = sc.apply_boolean_mask
    monkeypatch.setattr(sc, "apply_boolean_mask",
                        lambda t, m: seen.append(t.names) or inner(t, m))
    df = pd.DataFrame({"a": [1.0, 2.0], "b": [3.0, 4.0], "c": [5, 6]})
    plan = TIR.Select((TE.NamedExpr("a2", TE.col("a") * 2),), children=(
        TIR.Filter(TE.col("c") > 5, children=(_scan("port", df),)),))
    assert TIR.execute(plan).to_pandas()["a2"].tolist() == [4.0]
    assert seen == [["a"]]


def test_scan_and_sink_plans_match_reference(tmp_path):
    """Scan -> Filter -> HStack (a string and a temporal expression) ->
    Sink, on both packages; the sunk files read back equal."""
    df = _frame(300, seed=3)
    src = str(tmp_path / "src.parquet")
    df.to_parquet(src)
    outs = {}
    for pkg in ("ref", "port"):
        E, IR, _ = PKGS[pkg]
        scan = (IR.Scan("parquet", (src,)) if pkg == "ref"
                else IR.Scan("parquet", (src,), device="cpu"))
        dst = str(tmp_path / f"{pkg}.parquet")
        plan = IR.Sink("parquet", dst, children=(
            IR.HStack((E.NamedExpr("is_d", E.col("s").str.contains("^d")),
                       E.NamedExpr("year", E.col("t").dt.year())), children=(
                IR.Filter(E.col("a") > 0, children=(scan,)),)),))
        outs[pkg] = (IR.execute(plan).to_pandas(), pd.read_parquet(dst))
    pd.testing.assert_frame_equal(outs["port"][0], outs["ref"][0])
    pd.testing.assert_frame_equal(outs["port"][1], outs["ref"][1])
    back = TIR.execute(TIR.Scan("parquet", (str(tmp_path / "port.parquet"),),
                                device="cpu")).to_pandas()
    pd.testing.assert_frame_equal(back, outs["port"][0], check_dtype=False)
    for fmt in ("csv", "json"):
        dst = str(tmp_path / f"out.{fmt}")
        plan = TIR.Sink(fmt, dst, children=(
            TIR.Projection(("a", "j"), children=(
                TIR.Scan("parquet", (src,), device="cpu"),)),))
        TIR.execute(plan)
        back = TIR.execute(TIR.Scan(fmt, (dst,), device="cpu")).to_pandas()
        np.testing.assert_allclose(back["j"].to_numpy(), df["j"].to_numpy())
