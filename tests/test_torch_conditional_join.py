"""The port's conditional and mixed joins (``ops/join.py``) and the IR's
``ConditionalJoin`` against cudf_tpu's and pandas.

Tolerance: exact. ``conditional_join`` gives rows in left-row order and,
within a left row, in right-row order, in both packages and whatever the
block size, so tables are compared row for row; ``mixed_join``'s inner and
left joins are compared as sorted row sets (the equi-join's order is the
lane's), semi and anti row for row.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR
from cudf_tpu.expr.lowering import LoweringConfig as RConfig
from cudf_tpu.expr.lowering import lower_ir_graph as rlower
from cudf_tpu.ops import join as RJ

import cudf_tpu_torch as tt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.expr.lowering import LoweringConfig, lower_ir_graph
from cudf_tpu_torch.ops import join as TJ

HOWS = ["inner", "left", "semi", "anti"]


def _frames(nl=300, nr=70, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    l = pd.DataFrame({"a": rng.integers(0, 50, nl), "k": rng.integers(0, 12, nl),
                      "x": np.round(rng.normal(size=nl), 3)})
    r = pd.DataFrame({"b": rng.integers(0, 50, nr), "k": rng.integers(0, 12, nr),
                      "y": np.round(rng.normal(size=nr), 3)})
    if nulls:
        l["a"] = pd.array(l["a"], dtype="Int64")
        l.loc[rng.random(nl) < 0.1, "a"] = pd.NA
        r.loc[rng.random(nr) < 0.1, "y"] = np.nan
    return l, r


def _tables(l, r):
    return ((ct.Table.from_pandas(l), ct.Table.from_pandas(r)),
            (tt.Table.from_pandas(l, device="cpu"), tt.Table.from_pandas(r, device="cpu")))


def _assert_tables_equal(got, want, sort=False):
    g, w = got.to_pandas(), want.to_pandas()
    assert list(g.columns) == list(w.columns)
    if sort:
        g = g.sort_values(list(g.columns), ignore_index=True)
        w = w.sort_values(list(w.columns), ignore_index=True)
    pd.testing.assert_frame_equal(g, w, check_dtype=False)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("block_rows", [None, 7, 64])
def test_conditional_join_matches_reference_row_for_row(how, block_rows):
    l, r = _frames()
    (rl, rr), (tl, tr) = _tables(l, r)
    got = TJ.conditional_join(tl, tr, lambda t: TE.evaluate(
        (TE.col("a") + TE.col("b")) > 70, t), how, block_rows=block_rows)
    want = RJ.conditional_join(rl, rr, lambda t: RE.evaluate(
        (RE.col("a") + RE.col("b")) > 70, t), how, block_rows=64)
    _assert_tables_equal(got, want)
    if how == "inner":
        cross = l.merge(r, how="cross")
        assert got.num_rows == int(((cross.a + cross.b) > 70).fillna(False).sum())


@pytest.mark.parametrize("how", HOWS)
def test_conditional_join_empty_sides_and_never_true(how):
    l, r = _frames(nulls=False)
    for left, right in ((l, r.iloc[:0]), (l.iloc[:0], r), (l, r)):
        (rl, rr), (tl, tr) = _tables(left, right)
        got = TJ.conditional_join(tl, tr, lambda t: TE.evaluate(TE.col("a") < TE.col("b") - 100,
                                                               t), how)
        want = RJ.conditional_join(rl, rr, lambda t: RE.evaluate(
            RE.col("a") < RE.col("b") - 100, t), how)
        assert got.num_rows == want.num_rows
        assert got.names == want.names


def test_conditional_join_reads_only_the_predicates_columns():
    l, r = _frames(nulls=False)
    (_, _), (tl, tr) = _tables(l, r)
    seen = []

    def pred(t):
        if isinstance(t, tt.Table):
            seen.append(set(t.names))
        return TE.evaluate(TE.col("a") < TE.col("b"), t)

    TJ.conditional_join(tl, tr, pred, "inner", block_rows=50)
    assert seen and all(s == {"a", "b"} for s in seen)


def test_block_rows_come_from_the_memory_limit(monkeypatch):
    from cudf_tpu_torch.ops import chunked

    assert TJ._block_rows(1000, 100, tt.Table.from_pandas(
        pd.DataFrame({"a": [1]}), device="cpu").device) == 1000
    monkeypatch.setattr(chunked, "CPU_LIMIT_BYTES", TJ.PAIR_BYTES * 1500)
    l, r = _frames(nulls=False)
    (rl, rr), (tl, tr) = _tables(l, r)
    assert TJ._block_rows(300, 70, tl.device) == 1024 // 70  # pairs held to 2^10
    got = TJ.conditional_join(tl, tr, lambda t: TE.evaluate(TE.col("a") > TE.col("b"), t))
    want = RJ.conditional_join(rl, rr, lambda t: RE.evaluate(RE.col("a") > RE.col("b"), t))
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("nulls_equal", [False, True])
def test_mixed_join_matches_reference(how, nulls_equal):
    l, r = _frames(seed=1)
    l["k"] = pd.array(l["k"], dtype="Int64")
    l.loc[l.index % 17 == 0, "k"] = pd.NA
    (rl, rr), (tl, tr) = _tables(l, r)
    got = TJ.mixed_join(tl, tr, ["k"], ["k"], lambda t: TE.evaluate(TE.col("x") < TE.col("y"), t),
                        how, nulls_equal)
    want = RJ.mixed_join(rl, rr, ["k"], ["k"], lambda t: RE.evaluate(RE.col("x") < RE.col("y"), t),
                         how, nulls_equal)
    _assert_tables_equal(got, want, sort=how in ("inner", "left"))
    lm = l.reset_index().rename(columns={"index": "_lid"})
    m = lm.dropna(subset=["k"]).merge(r, on="k")
    m = m[m.x < m.y]
    if not nulls_equal:
        if how == "semi":
            np.testing.assert_array_equal(got.to_pandas()["x"],
                                          l.x.to_numpy()[sorted(set(m._lid))])
        if how == "inner":
            assert got.num_rows == len(m)


def test_ir_conditional_join_and_its_lowering_match_reference():
    l, r = _frames(nl=120, nr=40, seed=2, nulls=False)
    (rl, rr), (tl, tr) = _tables(l, r)
    rplan = RIR.ConditionalJoin(RE.col("a") < RE.col("b"), "inner",
                                children=(RIR.DataFrameScan(rl), RIR.DataFrameScan(rr)))
    tplan = TIR.ConditionalJoin(TE.col("a") < TE.col("b"), "inner",
                                children=(TIR.DataFrameScan(tl), TIR.DataFrameScan(tr)))
    _assert_tables_equal(TIR.execute(tplan), RIR.execute(rplan))
    want = l.merge(r, how="cross")
    assert TIR.execute(tplan).num_rows == int((want.a < want.b).sum())
    cfg = (l.memory_usage().sum() // 4, 1)  # lineitem-like left in partitions
    tl_plan, tinfo = lower_ir_graph(tplan, LoweringConfig(*cfg))
    rl_plan, rinfo = rlower(rplan, RConfig(*cfg))

    def sig(n, info):
        return (type(n).__name__, info[n].count, tuple(sig(c, info) for c in n.children))

    assert sig(tl_plan, tinfo) == sig(rl_plan, rinfo)


@pytest.mark.parametrize("unit", ["us", "ns"])
def test_timestamp_plus_a_duration_literal_in_another_unit(unit):
    """A mixed join's residual ``l_shipdate > o_orderdate + 60 days``: the
    day literal is converted to the column's unit (the port added its raw
    count of days as microseconds before)."""
    df = pd.DataFrame({"a": pd.to_datetime(["2020-01-01", "2020-06-01"]).astype(
        f"datetime64[{unit}]"), "b": pd.to_datetime(["2019-12-01", "2020-02-20"]).astype(
        f"datetime64[{unit}]")})
    lit = np.timedelta64(60, "D")
    t, r = tt.Table.from_pandas(df, device="cpu"), ct.Table.from_pandas(df)
    got = TE.evaluate(TE.col("b") + TE.Literal(lit), t).to_numpy()
    np.testing.assert_array_equal(got, RE.evaluate(RE.col("b") + RE.Literal(lit), r).to_numpy())
    np.testing.assert_array_equal(got, (df["b"] + pd.Timedelta(days=60)).to_numpy())
    np.testing.assert_array_equal(
        TE.evaluate(TE.col("a") > TE.col("b") + TE.Literal(lit), t).to_numpy(), [False, True])
