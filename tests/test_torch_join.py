"""The port's join against cudf_tpu's, lane by lane.

Same pandas inputs, made from a seed, go through both packages (the port
on the CPU, where the hash-table lane runs the probe kernel's plain
version). Keys, row ids, counts, null masks and gathered payloads are
compared exactly: a join moves values, it does not compute them. With
``ordered=True`` the output must equal the reference's row for row; with
``ordered=False`` as a multiset (each side carries a row-id column).
Spies assert the lane: a distinct build side takes ``try_fast_join`` (the
probe ran), a duplicate one the general sort lane (``_probe``).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.ops.binaryop import binary_op as r_binary_op
from cudf_tpu.ops.join import cross_join as r_cross_join
from cudf_tpu.ops.join import join as r_join
from cudf_tpu.ops.stream_compaction import apply_boolean_mask as r_apply_boolean_mask

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import dtypes as tdt
from cudf_tpu_torch.core.column import Column as TColumn
from cudf_tpu_torch.kernels import hashtable as tht
from cudf_tpu_torch.ops import join as tjoin

HOWS = ["inner", "left", "right", "semi", "anti", "full"]


class Spy:
    """Counts calls of a module function (a lane counter for the tests)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        inner = getattr(module, name)

        def wrapper(*a, **k):
            self.calls += 1
            return inner(*a, **k)

        monkeypatch.setattr(module, name, wrapper)


def _nullable(vals, null):
    return pd.arrays.IntegerArray(np.asarray(vals, np.int64), np.asarray(null, bool))


def _case(name):
    """(left frame, right frame, left_on, right_on, nulls_equal, lanes);
    ``lanes`` = (keys pack into 64 bits, left keys distinct, right keys
    distinct), distinctness over the rows that can match."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "basic":  # tests/test_join.py:21-27
        return (pd.DataFrame({"k": [1, 2, 3, 2], "a": [10.0, 20.0, 30.0, 40.0]}),
                pd.DataFrame({"k": [2, 2, 4], "b": [100.0, 200.0, 300.0]}),
                ["k"], ["k"], False, (True, False, False))
    if name == "no_matches":  # :29-33
        return (pd.DataFrame({"k": [1, 2]}), pd.DataFrame({"k": [3, 4]}),
                ["k"], ["k"], False, (True, True, True))
    if name == "multi_key_mixed_dtypes":  # :35-50; the f64 key's code needs 63 bits
        n = 2000
        return (pd.DataFrame({"k1": rng.integers(0, 30, n),
                              "k2": rng.integers(0, 5, n).astype(np.float64),
                              "v": np.arange(n)}),
                pd.DataFrame({"k1": rng.integers(0, 30, 500),
                              "k2": rng.integers(0, 5, 500).astype(np.float64),
                              "w": np.arange(500) * 1.5}),
                ["k1", "k2"], ["k1", "k2"], False, (False, False, False))
    if name == "left_order":  # :52-57
        return (pd.DataFrame({"k": [3, 1, 2], "a": [1, 2, 3]}),
                pd.DataFrame({"k": [1, 2, 3], "b": [10, 20, 30]}),
                ["k"], ["k"], False, (True, True, True))
    if name == "string_keys":  # :59-64, dictionaries unified across sides
        return (pd.DataFrame({"k": np.array(["a", "b", "c"], object), "v": [1, 2, 3]}),
                pd.DataFrame({"k": np.array(["b", "c", "d"], object), "w": [20, 30, 40]}),
                ["k"], ["k"], False, (True, True, True))
    if name == "dtype_promotion":  # :66-70, int32 against int64
        return (pd.DataFrame({"k": np.array([1, 2], np.int32), "v": [1, 2]}),
                pd.DataFrame({"k": np.array([2, 3], np.int64), "w": [20, 30]}),
                ["k"], ["k"], False, (True, True, True))
    if name == "different_key_names":  # :72-77
        return (pd.DataFrame({"lk": [1, 2], "v": [1, 2]}),
                pd.DataFrame({"rk": [2, 3], "w": [20, 30]}),
                ["lk"], ["rk"], False, (True, True, True))
    if name in ("nulls", "nulls_equal"):  # :100-112
        return (pd.DataFrame({"k": _nullable([1, 2, 0], [0, 0, 1]), "v": [1, 2, 3]}),
                pd.DataFrame({"k": _nullable([2, 0], [0, 1]), "w": [20, 30]}),
                ["k"], ["k"], name == "nulls_equal", (True, True, True))
    if name == "two_null_build_keys":  # null == null makes the build side repeat
        return (pd.DataFrame({"k": _nullable([1, 2, 0], [0, 0, 1]), "v": [1, 2, 3]}),
                pd.DataFrame({"k": _nullable([2, 0, 0], [0, 1, 1]), "w": [20, 30, 40]}),
                ["k"], ["k"], True, (True, True, False))
    if name == "nan":  # :114-120: NaN matches NaN, -0 matches +0
        return (pd.DataFrame({"k": [1.0, np.nan, -0.0], "v": [1, 2, 3]}),
                pd.DataFrame({"k": [np.nan, 2.0, 0.0], "w": [30, 40, 50]}),
                ["k"], ["k"], False, (True, True, True))
    if name == "orders_lineitem":  # :157-173: orders left, lineitem (build) right
        no, ni = 5000, 20000
        return (pd.DataFrame({"o_orderkey": np.arange(no),
                              "o_totalprice": rng.uniform(100, 10000, no)}),
                pd.DataFrame({"l_orderkey": rng.integers(0, no, ni),
                              "l_quantity": rng.integers(1, 50, ni).astype(np.float64)}),
                ["o_orderkey"], ["l_orderkey"], False, (True, True, False))
    if name == "lineitem_orders":  # the fact -> dimension direction
        left, right, lo, ro, ne, _ = _case("orders_lineitem")
        return right, left, ro, lo, ne, (True, False, True)
    if name == "bench_join":  # bench.py:103-111 at N = 20000
        n, nd = 20000, 1000
        return (pd.DataFrame({"k": rng.integers(0, nd, n),
                              "v": rng.normal(size=n).astype(np.float32)}),
                pd.DataFrame({"k": np.arange(nd),
                              "w": rng.normal(size=nd).astype(np.float32)}),
                ["k"], ["k"], False, (True, False, True))
    if name == "bench_join_i64":  # bench.py:115-121: sparse 62-bit keys, two words
        n, nd = 20000, 1000
        dim = np.unique(rng.integers(0, 2**62, nd, dtype=np.int64))
        return (pd.DataFrame({"k": dim[rng.integers(0, len(dim), n)],
                              "v": rng.normal(size=n).astype(np.float32)}),
                pd.DataFrame({"k": dim, "w": rng.normal(size=len(dim)).astype(np.float32)}),
                ["k"], ["k"], False, (True, False, True))
    if name == "non_distinct_both":
        return (pd.DataFrame({"k": rng.integers(0, 50, 1000), "v": np.arange(1000)}),
                pd.DataFrame({"k": rng.integers(0, 50, 300), "w": np.arange(300) * 2.0}),
                ["k"], ["k"], False, (True, False, False))
    if name == "payload_name_clash":  # a non-key column on both sides: suffixes
        return (pd.DataFrame({"k": [1, 2, 3], "x": [1.0, 2.0, 3.0]}),
                pd.DataFrame({"k": [3, 1], "x": [30.0, 10.0], "y": [7, 8]}),
                ["k"], ["k"], False, (True, True, True))
    raise KeyError(name)


CASES = ["basic", "no_matches", "multi_key_mixed_dtypes", "left_order", "string_keys",
         "dtype_promotion", "different_key_names", "nulls", "nulls_equal",
         "two_null_build_keys", "nan", "orders_lineitem", "lineitem_orders",
         "bench_join", "bench_join_i64", "non_distinct_both", "payload_name_clash"]


def _expected_lanes(how, lanes):
    """(probe kernel runs, general lane runs) for ``how``."""
    packs, ldist, rdist = lanes
    if not packs:
        return False, True
    if how in ("semi", "anti"):
        return True, False
    if how == "right":
        return ldist, not ldist
    if how == "full":  # a left join, then an anti join of the right side
        return True, not rdist
    return rdist, not rdist


def _tables(ldf, rdf):
    return ((ct.Table.from_pandas(ldf), ct.Table.from_pandas(rdf)),
            (tt.Table.from_pandas(ldf, device="cpu"), tt.Table.from_pandas(rdf, device="cpu")))


def assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame):
    """Same columns in the same order, every value and null equal."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want), (len(got), len(want))
    for name in want.columns:
        g, w = got[name].to_numpy(), want[name].to_numpy()
        gn, wn = pd.isna(g), pd.isna(w)
        np.testing.assert_array_equal(gn, wn, err_msg=name)
        np.testing.assert_array_equal(g[~gn], w[~wn], err_msg=name)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("name", CASES)
def test_join_matches_reference_row_for_row(monkeypatch, name, how):
    ldf, rdf, lon, ron, nulls_equal, lanes = _case(name)
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    if (name, how) == ("dtype_promotion", "full"):
        # the unmatched right rows keep their int64 key beside the left
        # join's int32 key: both packages refuse to concatenate them
        with pytest.raises(AssertionError):
            r_join(rl, rr, lon, ron, how, nulls_equal)
        with pytest.raises(TypeError, match="one dtype"):
            tt.join(pl, pr, lon, ron, how, nulls_equal)
        return
    want = r_join(rl, rr, lon, ron, how, nulls_equal).to_pandas()
    probe = Spy(monkeypatch, tht, "probe_table")
    general = Spy(monkeypatch, tjoin, "_probe")
    got = tt.join(pl, pr, lon, ron, how, nulls_equal).to_pandas()
    assert_frames_equal(got, want)
    assert (probe.calls > 0, general.calls > 0) == _expected_lanes(how, lanes)


UNORDERED = ["bench_join", "bench_join_i64", "orders_lineitem", "lineitem_orders",
             "non_distinct_both", "nulls"]


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("name", UNORDERED)
def test_unordered_join_matches_reference_as_multiset(name, how):
    ldf, rdf, lon, ron, nulls_equal, _ = _case(name)
    ldf = ldf.assign(lid=np.arange(len(ldf)))
    rdf = rdf.assign(rid=np.arange(len(rdf)))
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    want = r_join(rl, rr, lon, ron, how, nulls_equal, ordered=False).to_pandas()
    got = tt.join(pl, pr, lon, ron, how, nulls_equal, ordered=False).to_pandas()
    assert sorted(got.columns) == sorted(want.columns)
    ids = [c for c in ("lid", "rid") if c in want.columns]
    got = got[list(want.columns)].sort_values(ids, kind="stable").reset_index(drop=True)
    want = want.sort_values(ids, kind="stable").reset_index(drop=True)
    assert_frames_equal(got, want)


@pytest.mark.parametrize("name", ["bench_join", "bench_join_i64"])
def test_join_filter_matches_reference(name):
    """bench.py's join_filter: an unordered inner join, then
    binary_op(w > 0) and apply_boolean_mask."""
    ldf, rdf, lon, ron, _, _ = _case(name)
    ldf = ldf.assign(lid=np.arange(len(ldf)))
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    r = r_join(rl, rr, lon, ron, "inner", ordered=False)
    want = r_apply_boolean_mask(r, r_binary_op(r["w"], 0.0, "gt")).to_pandas()
    p = tt.join(pl, pr, lon, ron, "inner", ordered=False)
    got = tt.apply_boolean_mask(p, tt.binary_op(p["w"], 0.0, "gt")).to_pandas()
    assert 0 < len(got) < len(ldf)
    assert_frames_equal(got.sort_values("lid").reset_index(drop=True),
                        want.sort_values("lid").reset_index(drop=True))


def test_join_against_pandas_merge():
    """The orders x lineitem shape against pandas itself (inner, left)."""
    ldf, rdf, lon, ron, _, _ = _case("lineitem_orders")
    (_, _), (pl, pr) = _tables(ldf, rdf)
    for how in ("inner", "left"):
        got = tt.join(pl, pr, lon, ron, how).to_pandas()
        want = ldf.merge(rdf, left_on=lon, right_on=ron, how=how)
        assert_frames_equal(got, want[list(got.columns)])


def test_cross_join_matches_reference():
    ldf = pd.DataFrame({"a": [1, 2], "x": [0.5, 1.5]})
    rdf = pd.DataFrame({"b": [10, 20, 30], "x": [1.0, 2.0, 3.0]})
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    assert_frames_equal(tt.cross_join(pl, pr).to_pandas(),
                        r_cross_join(rl, rr).to_pandas())


def test_empty_sides_match_reference():
    ldf = pd.DataFrame({"k": np.array([], np.int64), "v": np.array([], np.float64)})
    rdf = pd.DataFrame({"k": [1, 2], "w": [1.0, 2.0]})
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    for how in HOWS:
        assert_frames_equal(tt.join(pl, pr, ["k"], ["k"], how).to_pandas(),
                            r_join(rl, rr, ["k"], ["k"], how).to_pandas())
        assert_frames_equal(tt.join(pr, pl, ["k"], ["k"], how).to_pandas(),
                            r_join(rr, rl, ["k"], ["k"], how).to_pandas())


def test_categorical_keys_are_not_ported_yet():
    t = tt.Table({"k": TColumn(tdt.DType(tdt.Kind.DICTIONARY, 32),
                               torch.zeros(128, dtype=torch.int32), None, 3)})
    with pytest.raises(NotImplementedError):
        tt.join(t, t, ["k"], ["k"])


def test_unknown_how_raises():
    t = tt.Table.from_pandas(pd.DataFrame({"k": [1]}), device="cpu")
    with pytest.raises(ValueError, match="unknown join type"):
        tt.join(t, t, ["k"], ["k"], "outer")


def test_build_grows_past_long_probe_chains(monkeypatch):
    """16,000 distinct build keys in table_size_for's 32,768 slots (49%
    load) leave some key more than MAX_PROBE slots from home; the lane
    rebuilds in a larger table and still takes the probe kernel."""
    rng = np.random.default_rng(5)
    dim = rng.choice(2**40, 16_000, replace=False)
    ldf = pd.DataFrame({"k": dim[rng.integers(0, len(dim), 5000)]})
    rdf = pd.DataFrame({"k": dim, "w": np.arange(len(dim))})
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    sizes = []
    build = tht.build_table

    def spy(k1, k2, valid, m):
        out = build(k1, k2, valid, m)
        sizes.append((m, out[3]))
        return out

    monkeypatch.setattr(tht, "build_table", spy)
    got = tt.join(pl, pr, ["k"], ["k"]).to_pandas()
    assert_frames_equal(got, r_join(rl, rr, ["k"], ["k"]).to_pandas())
    assert len(sizes) > 1 and sizes[0][0] == tht.table_size_for(len(dim))
    assert sizes[-1][1] and not any(placed for _, placed in sizes[:-1])
    assert [m for m, _ in sizes] == [sizes[0][0] << i for i in range(len(sizes))]


def _swap_case(name):
    """(left, right, left_on, right_on, nulls_equal): the left side distinct
    and smaller than the right, as the dimension side of TPC-H's plans."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "orders_lineitem":
        ldf, rdf, lon, ron, ne, _ = _case("orders_lineitem")
        return ldf, rdf, lon, ron, ne
    if name == "suffixes":  # payload names on both sides, one shared key name
        return (pd.DataFrame({"k": np.arange(40), "x": np.arange(40) * 1.5,
                              "s": np.array(["a", "b"], object)[np.arange(40) % 2]}),
                pd.DataFrame({"k": rng.integers(0, 60, 300), "x": rng.normal(size=300),
                              "w": np.arange(300)}),
                ["k"], ["k"], False)
    if name == "nullable_keys":  # null keys on both sides never match
        return (pd.DataFrame({"lk": _nullable(np.arange(30), np.arange(30) % 7 == 0),
                              "v": np.arange(30)}),
                pd.DataFrame({"rk": _nullable(rng.integers(0, 35, 200), rng.random(200) < 0.1),
                              "w": rng.normal(size=200)}),
                ["lk"], ["rk"], False)
    if name == "two_keys_promoted":  # q5's two-key join, int32 against int64
        s = np.arange(50)
        return (pd.DataFrame({"s_suppkey": s, "s_nationkey": (s % 5).astype(np.int32)}),
                pd.DataFrame({"l_suppkey": rng.integers(0, 60, 400),
                              "c_nationkey": rng.integers(0, 5, 400),
                              "rev": rng.normal(size=400)}),
                ["s_suppkey", "s_nationkey"], ["l_suppkey", "c_nationkey"], False)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["orders_lineitem", "suffixes", "nullable_keys",
                                  "two_keys_promoted"])
def test_swapped_inner_join_equals_the_general_lane(monkeypatch, name):
    """An unordered inner join whose left side is distinct and smaller builds
    on the left (the swap): the same columns in the same order, suffixes
    included, and the same rows as the general lane and the reference, as
    a multiset."""
    from cudf_tpu_torch.ops import fastjoin as tfast

    ldf, rdf, lon, ron, ne = _swap_case(name)
    ldf = ldf.assign(lid=np.arange(len(ldf)))
    rdf = rdf.assign(rid=np.arange(len(rdf)))
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    builds = []
    match = tfast._match
    monkeypatch.setattr(tfast, "_match", lambda probe, build, *a: builds.append(
        build is pl) or match(probe, build, *a))
    general = Spy(monkeypatch, tjoin, "_probe")
    got = tt.join(pl, pr, lon, ron, "inner", ne, ordered=False).to_pandas()
    assert builds == [True] and general.calls == 0
    monkeypatch.setattr(tfast, "try_fast_join", lambda *a, **k: None)
    want = tt.join(pl, pr, lon, ron, "inner", ne, ordered=False).to_pandas()
    assert general.calls == 1
    ref = r_join(rl, rr, lon, ron, "inner", ne, ordered=False).to_pandas()
    assert list(got.columns) == list(want.columns) == list(ref.columns)
    for other in (want, ref):
        assert_frames_equal(got.sort_values(["lid", "rid"]).reset_index(drop=True),
                            other.sort_values(["lid", "rid"]).reset_index(drop=True))


def test_duplicates_on_both_sides_still_reach_the_general_lane(monkeypatch):
    ldf, rdf, lon, ron, ne, _ = _case("non_distinct_both")
    ldf = ldf.iloc[:200]  # the left side smaller: the swap is tried first
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    probe = Spy(monkeypatch, tht, "probe_table")
    general = Spy(monkeypatch, tjoin, "_probe")
    got = tt.join(pl, pr, lon, ron, "inner", ne, ordered=False).to_pandas()
    assert probe.calls == 0 and general.calls == 1
    want = r_join(rl, rr, lon, ron, "inner", ne, ordered=False).to_pandas()
    cols = list(want.columns)
    assert_frames_equal(got.sort_values(cols).reset_index(drop=True),
                        want.sort_values(cols).reset_index(drop=True))


@pytest.mark.parametrize("name", ["orders_lineitem", "suffixes"])
def test_ordered_join_never_swaps(monkeypatch, name):
    """ordered=True keeps left-row order: no build on the left side, rows
    equal to the reference's row for row."""
    from cudf_tpu_torch.ops import fastjoin as tfast

    ldf, rdf, lon, ron, ne = _swap_case(name)
    (rl, rr), (pl, pr) = _tables(ldf, rdf)
    calls = []
    fast = tfast.try_fast_join
    monkeypatch.setattr(tfast, "try_fast_join", lambda *a, **k: calls.append(
        k.get("build_left", False)) or fast(*a, **k))
    got = tt.join(pl, pr, lon, ron, "inner", ne, ordered=True).to_pandas()
    assert calls == [False]
    assert_frames_equal(got, r_join(rl, rr, lon, ron, "inner", ne).to_pandas())
