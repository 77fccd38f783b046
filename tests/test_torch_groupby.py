"""The port's groupby_aggregate against cudf_tpu's, lane by lane.

Same pandas inputs, made from a seed, go through both packages (the port
on the CPU, where the one-hot lane runs its kernel's plain version).
Tolerances: keys, counts, group order and null masks exact; f64 aggregates
rtol 1e-9; f32 sums rtol 1e-5, because the reference's lanes round f32
differently. Against the reference's Pallas lane, whose mean divides an
f32 sum, the mean too is held to rtol 1e-5.
"""
import math

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.ops import fastgroup as rfast
from cudf_tpu.ops import groupby as rgb
from cudf_tpu.ops import stream_compaction as rsc
from cudf_tpu.ops.sortprim import multisort_perm as r_multisort_perm
from cudf_tpu.utils.jitutil import fix_lengths
from cudf_tpu.utils.padding import bucket_capacity

import cudf_tpu_torch as tt
from cudf_tpu_torch.core.column import Column as TColumn
from cudf_tpu_torch.core import dtypes as tdt
from cudf_tpu_torch.ops import fastgroup as tfast
from cudf_tpu_torch.ops import groupby as tgb
from cudf_tpu_torch.ops import sortgroup as tsort
from cudf_tpu_torch.ops import stream_compaction as tsc
from cudf_tpu_torch.ops.sortprim import multisort_perm as t_multisort_perm


def assert_same(got: pd.DataFrame, want: pd.DataFrame, rtol=None):
    """Non-float columns exactly equal; float columns to ``rtol[name]``
    (default 1e-9), NaN where the other has NaN."""
    rtol = rtol or {}
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want), (len(got), len(want))
    for name in want.columns:
        g, w = got[name].to_numpy(), want[name].to_numpy()
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=rtol.get(name, 1e-9), atol=1e-12,
                                       equal_nan=True, err_msg=name)
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            gn, wn = pd.isna(g), pd.isna(w)
            np.testing.assert_array_equal(gn, wn, err_msg=name)
            np.testing.assert_array_equal(g[~gn], w[~wn], err_msg=name)


class Spy:
    """Counts calls of a module function (a lane counter for the tests)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        inner = getattr(module, name)

        def wrapper(*a, **k):
            self.calls += 1
            return inner(*a, **k)

        monkeypatch.setattr(module, name, wrapper)


def _aggs(specs):
    return ([rgb.AggSpec(*s) for s in specs], [tgb.AggSpec(*s) for s in specs])


README_AGGS = [("v", "sum", "s"), ("v", "mean", "m"), ("v", "count", "c"),
               ("", "size", "n")]


def _readme_frame(n, seed):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "a": pd.arrays.IntegerArray(rng.integers(0, 3, n).astype(np.int32),
                                    rng.random(n) < 0.05),
        "b": pd.arrays.IntegerArray(rng.integers(0, 2, n).astype(np.int32),
                                    rng.random(n) < 0.05),
        "v": rng.uniform(900, 105000, n).astype(np.float32),
    })


@pytest.mark.parametrize("n", [1000, 20000])
def test_readme_path_matches_reference(monkeypatch, n):
    """from_pandas -> drop_nulls -> groupby sum/mean/count/size -> to_pandas,
    the port through its one-hot lane, the reference through its default
    (sort) lane, and both against pandas."""
    df = _readme_frame(n, seed=n)
    raggs, taggs = _aggs(README_AGGS)
    onehot = Spy(monkeypatch, tfast, "_onehot_groupby")
    want = rgb.groupby_aggregate(rsc.drop_nulls(ct.Table.from_pandas(df)),
                                 ["a", "b"], raggs).to_pandas()
    got = tgb.groupby_aggregate(tsc.drop_nulls(tt.Table.from_pandas(df, device="cpu")),
                                ["a", "b"], taggs).to_pandas()
    assert onehot.calls == 1
    assert_same(got, want, {"s": 1e-5})
    pdw = df.dropna().groupby(["a", "b"], sort=True).agg(
        s=("v", "sum"), m=("v", "mean"), c=("v", "count"), n=("v", "size")).reset_index()
    np.testing.assert_array_equal(got[["a", "b", "c", "n"]].to_numpy(),
                                  pdw[["a", "b", "c", "n"]].to_numpy())
    np.testing.assert_allclose(got["m"], pdw["m"], rtol=1e-6)


ONEHOT_CASES = {
    "nullable_ints": (lambda rng, n: {
        "a": pd.arrays.IntegerArray(rng.integers(-2, 5, n), rng.random(n) < 0.1),
        "b": rng.integers(0, 3, n).astype(np.int16)}, ["a", "b"]),
    "string_and_bool": (lambda rng, n: {
        "a": np.array(["x", "y", None, "zz"], object)[rng.integers(0, 4, n)],
        "b": rng.random(n) < 0.5}, ["a", "b"]),
    "float_key_with_nan": (lambda rng, n: {
        "a": np.where(rng.random(n) < 0.1, np.nan,
                      rng.integers(0, 20, n).astype(np.float64))}, ["a"]),
}


@pytest.mark.parametrize("case", sorted(ONEHOT_CASES))
@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("specs", [README_AGGS, [("", "size", "n")]],
                         ids=["sum_mean_count_size", "size_only"])
def test_onehot_lane_matches_pallas_lane(monkeypatch, case, dropna, specs):
    """The port's lane against the reference's _pallas_onehot_groupby,
    reached through fast_groupby with CUDF_TPU_PALLAS=1."""
    monkeypatch.setenv("CUDF_TPU_PALLAS", "1")
    rng = np.random.default_rng(4)
    n = 5000
    make, keys = ONEHOT_CASES[case]
    df = pd.DataFrame({**make(rng, n), "v": rng.normal(size=n).astype(np.float32)})
    raggs, taggs = _aggs(specs)
    pallas = Spy(monkeypatch, rfast, "_pallas_onehot_groupby")
    onehot = Spy(monkeypatch, tfast, "_onehot_groupby")
    want = rfast.fast_groupby(ct.Table.from_pandas(df), keys, raggs, dropna).to_pandas()
    got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), keys, taggs,
                                dropna).to_pandas()
    assert pallas.calls == 1 and onehot.calls == 1
    assert_same(got, want, {"s": 1e-5, "m": 1e-5})


def _nullable(rng, vals, p):
    return pd.arrays.FloatingArray(vals.astype(np.float64), rng.random(len(vals)) < p)


BENCH_SHAPES = {
    # bench.py:161-181 at a small N: dropna + 2-key mean
    "dropna_2key_mean": (lambda rng, n: pd.DataFrame({
        "A": _nullable(rng, rng.integers(0, 1000, n), 0.01),
        "B": rng.integers(0, 50, n), "C": rng.normal(size=n)}), ["A", "B"], "mean", True),
    "string_key": (lambda rng, n: pd.DataFrame({
        "k": np.array([f"cust#{i:07d}" for i in range(1000)])[rng.integers(0, 1000, n)],
        "C": rng.normal(size=n)}), ["k"], "mean", False),
    "string_key_half_unique": (lambda rng, n: pd.DataFrame({
        "k": np.array([f"url/{i:09x}/page" for i in range(n // 2)])[
            rng.integers(0, n // 2, n)],
        "C": rng.normal(size=n)}), ["k"], "mean", False),
    "sparse_i64_mean": (lambda rng, n: pd.DataFrame({
        "k": np.unique(rng.integers(0, 2**62, n // 20, dtype=np.int64))[
            rng.integers(0, n // 20 - 1, n)],
        "C": rng.normal(size=n)}), ["k"], "mean", False),
    "sparse_i64_var": (lambda rng, n: pd.DataFrame({
        "k": np.unique(rng.integers(0, 2**62, n // 20, dtype=np.int64))[
            rng.integers(0, n // 20 - 1, n)],
        "C": rng.normal(size=n)}), ["k"], "var", False),
}


@pytest.mark.parametrize("shape", sorted(BENCH_SHAPES))
def test_sort_lane_bench_shapes(monkeypatch, shape):
    make, keys, kind, dropna_first = BENCH_SHAPES[shape]
    df = make(np.random.default_rng(2), 20000)
    raggs, taggs = _aggs([("C", kind, "C")])
    r, t = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    if dropna_first:
        r, t = rsc.drop_nulls(r), tsc.drop_nulls(t)
    sort_lane = Spy(monkeypatch, tsort, "sort_groupby")
    want = rgb.groupby_aggregate(r, keys, raggs).to_pandas()
    got = tgb.groupby_aggregate(t, keys, taggs).to_pandas()
    assert sort_lane.calls == 1
    assert_same(got, want)


AGG_KINDS = [("sum", 0), ("product", 0), ("min", 0), ("max", 0), ("count", 0),
             ("size", 0), ("any", 0), ("all", 0), ("mean", 0), ("var", 0),
             ("var", 0.0001), ("std", 0), ("m2", 0), ("nunique", 0), ("first", 0),
             ("last", 0), ("median", 0), ("quantile", 0.3), ("sum_of_squares", 0),
             ("argmin", 0), ("argmax", 0), ("nth", 1)]
AGG_IDS = [f"{k}{'_' + str(p) if p else ''}" for k, p in AGG_KINDS]


def _agg_frame(seed=6, n=3000):
    rng = np.random.default_rng(seed)
    x = 1.0 + 0.01 * rng.normal(size=n)
    x[rng.integers(0, n, 50)] = np.round(x[:50], 2)  # ties for argmin/nunique
    return pd.DataFrame({
        "g": pd.arrays.IntegerArray(rng.integers(0, 40, n), rng.random(n) < 0.05),
        "s": np.array(["p", "q", "r"], object)[rng.integers(0, 3, n)],
        "x": _nullable(rng, np.round(x, 3), 0.1),
        "i": pd.arrays.IntegerArray(rng.integers(-3, 4, n), rng.random(n) < 0.1),
    })


def _value_col(kind):
    return "i" if kind in ("any", "all", "nunique", "argmin", "argmax") else "x"


@pytest.mark.parametrize("kind,param", AGG_KINDS, ids=AGG_IDS)
@pytest.mark.parametrize("dropna", [True, False])
def test_every_agg_kind_through_dispatch(kind, param, dropna):
    df = _agg_frame()
    spec = [(_value_col(kind) if kind != "size" else "", kind, "out", param)]
    raggs, taggs = _aggs(spec)
    want = rgb.groupby_aggregate(ct.Table.from_pandas(df), ["g", "s"], raggs,
                                 dropna).to_pandas()
    got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["g", "s"],
                                taggs, dropna).to_pandas()
    assert_same(got, want)


@pytest.mark.parametrize("kind,param", AGG_KINDS, ids=AGG_IDS)
def test_every_agg_kind_generic_engine(kind, param):
    """_grouping + _aggregate_impl (the _compute_agg kinds), both packages."""
    df = _agg_frame(seed=8)
    vname = _value_col(kind)
    raggs, taggs = _aggs([(vname if kind != "size" else "", kind, "out", param)])
    r, t = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    rk, tk = (r["g"], r["s"]), (t["g"], t["s"])

    rperm, rseg, _, rinb, rng_dev = rgb._grouping(rk, True)
    n_groups = int(rng_dev)
    out_cap = bucket_capacity(max(n_groups, 1))
    rvp = (r_multisort_perm(list(rgb._value_sort_codes(rk, r[vname], kind != "nunique")))
           if kind in ("nunique", "median", "quantile") else None)
    rout = rgb._aggregate_impl(rk, (r[vname],), ("g", "s"), tuple(raggs), out_cap,
                               rperm, rseg, rinb, rng_dev, (rvp,))
    want = ct.Table(fix_lengths(rout, n_groups)).to_pandas()[["g", "s", "out"]]

    tperm, tseg, _, tinb, tn = tgb._grouping(tk, True)
    assert tn == n_groups
    tvp = (t_multisort_perm(tgb._value_sort_codes(tk, t[vname], kind != "nunique"))
           if kind in ("nunique", "median", "quantile") else None)
    tout = tgb._aggregate_impl(tk, (t[vname],), ("g", "s"), tuple(taggs), out_cap,
                               tperm, tseg, tinb, tn, (tvp,))
    got = tt.Table(tout).to_pandas()[["g", "s", "out"]]
    assert_same(got, want)


FAST_KINDS = [(k, p) for k, p in AGG_KINDS if k in tfast._SUPPORTED]


@pytest.mark.parametrize("kind,param", FAST_KINDS,
                         ids=[f"{k}{'_' + str(p) if p else ''}" for k, p in FAST_KINDS])
def test_fast_groupby_matches_reference(monkeypatch, kind, param):
    """fastgroup.fast_groupby of both packages, called directly, for every
    kind it answers (the reference without its Pallas switch)."""
    monkeypatch.delenv("CUDF_TPU_PALLAS", raising=False)
    df = _agg_frame(seed=9)
    spec = [(_value_col(kind) if kind != "size" else "", kind, "out", param)]
    raggs, taggs = _aggs(spec)
    want = rfast.fast_groupby(ct.Table.from_pandas(df), ["g", "s"], raggs, True)
    got = tfast.fast_groupby(tt.Table.from_pandas(df, device="cpu"), ["g", "s"],
                             taggs, True)
    assert want is not None and got is not None
    assert_same(got.to_pandas(), want.to_pandas())


@pytest.mark.parametrize("kind", ["argmin", "argmax"])
def test_dispatch_answers_argmin_argmax_from_fast_groupby(monkeypatch, kind):
    """argmin/argmax pass the one-hot and single-word sort lanes by and are
    answered by fast_groupby, not by the generic engine."""
    answered = []
    inner = tfast.fast_groupby

    def spy(*a, **k):
        out = inner(*a, **k)
        answered.append(out is not None)
        return out

    monkeypatch.setattr(tfast, "fast_groupby", spy)
    df = _agg_frame(seed=10)
    raggs, taggs = _aggs([("i", kind, "out")])
    want = rgb.groupby_aggregate(ct.Table.from_pandas(df), ["g", "s"], raggs).to_pandas()
    got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["g", "s"],
                                taggs).to_pandas()
    assert answered == [True]
    assert_same(got, want)


def test_entry_step_matches_reference():
    """__graft_entry__.entry(): the predicate folded into key validity, then
    _grouping + _aggregate_impl; the port runs the same step on the same
    buffers."""
    import __graft_entry__

    step, args = __graft_entry__.entry()
    want = [np.asarray(a) for a in step(*args)]
    flag, status, qty, price, ship = (torch.from_numpy(np.asarray(a)) for a in args[:5])
    length = int(args[5])
    keep = ship <= 2000
    fcol = TColumn(tdt.int32, flag, keep, length)
    scol = TColumn(tdt.int32, status, keep, length)
    kcols = (fcol, scol)
    perm, seg, _, inb, n_groups = tgb._grouping(kcols)
    vcols = (TColumn(tdt.float32, qty, keep, length),
             TColumn(tdt.float32, qty * price, keep, length),
             TColumn(tdt.float32, qty, keep, length), fcol)
    aggs = (tgb.AggSpec("qty", "sum", "sum_qty"), tgb.AggSpec("rev", "sum", "sum_rev"),
            tgb.AggSpec("qty", "mean", "avg_qty"), tgb.AggSpec("", "size", "n"))
    out = tgb._aggregate_impl(kcols, vcols, ("flag", "status"), aggs, 256, perm, seg,
                              inb, n_groups, (None,) * 4)
    got = [out[k].data.numpy() for k in ("flag", "status", "sum_qty", "sum_rev",
                                         "avg_qty", "n")]
    assert n_groups == 7  # 3 x 2 valid groups + the null-key group
    for name, g, w, rtol in zip(("flag", "status", "sum_qty", "sum_rev", "avg_qty", "n"),
                                got, want, (0, 0, 1e-5, 1e-5, 1e-9, 0)):
        g, w = g[:n_groups], w[:n_groups]
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("lane", ["onehot", "sort"])
def test_onehot_lane_keeps_nan_in_its_group(monkeypatch, lane):
    """A NaN value poisons only its own group's sum, in the port's one-hot
    lane (f32 values) and in its code-sort lane (f64 values), whose sums
    add each group's own rows. The reference's lanes spread it: the
    one-hot matmul multiplies the NaN by the zeros of every other group,
    and the sort lanes' prefix sums carry it into every later group."""
    dt = np.float32 if lane == "onehot" else np.float64
    df = pd.DataFrame({"k": np.array([0, 1, 2, 0, 1, 2], np.int32),
                       "v": np.array([1, np.nan, 3, 4, 5, 6], dt)})
    spy = (Spy(monkeypatch, tfast, "_onehot_groupby") if lane == "onehot"
           else Spy(monkeypatch, tsort, "sort_groupby"))
    got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["k"],
                                [tgb.AggSpec("v", "sum", "s")]).to_pandas()
    assert spy.calls == 1
    np.testing.assert_array_equal(got["s"].to_numpy(), np.array([5, np.nan, 9], dt))


@pytest.mark.parametrize("lane", ["sort", "fast"])
def test_a_small_group_keeps_its_precision_after_a_large_one(monkeypatch, lane):
    """A one-row group sorted after 10^6 rows of magnitude 10^6: its sum
    and mean equal pandas at rtol 1e-15, because each group adds only its
    own rows (a difference of prefix sums over the table would carry an
    error of ~1e-4 absolute into the small group). The big group, summed
    in another order than pandas', at rtol 1e-12; its var against numpy's
    two-pass var at rtol 1e-12 (pandas' own var is 2.5e-11 off it here)."""
    rng = np.random.default_rng(3)
    n = 10**6
    df = pd.DataFrame({"k": np.r_[np.zeros(n, np.int64), 1],
                       "v": np.r_[1e6 + rng.random(n), 1.2345678901234567]})
    aggs = [("sum", "sum"), ("mean", "mean"), ("var", "var")]
    specs = [tgb.AggSpec("v", kind, out) for kind, out in aggs]
    if lane == "fast":  # the code-sort lane that also answers argmin/argmax
        specs.append(tgb.AggSpec("v", "argmin", "am"))
        aggs.append(("idxmin", "am"))
    spy = Spy(monkeypatch, tsort if lane == "sort" else tfast,
              "sort_groupby" if lane == "sort" else "fast_groupby")
    got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["k"],
                                specs).to_pandas()
    assert spy.calls == 1
    want = df.groupby("k")["v"].agg([kind for kind, _ in aggs])
    big = df.v.to_numpy()[:n]
    want.loc[0, "var"] = ((big - big.mean()) ** 2).sum() / (n - 1)
    np.testing.assert_array_equal(got["k"].to_numpy(), [0, 1])
    for kind, out in aggs:
        g, w = got[out].to_numpy(), want[kind].to_numpy()
        np.testing.assert_allclose(g[0], w[0], rtol=1e-12, err_msg=kind)
        if kind == "var":  # one row: no variance
            assert np.isnan(g[1]) and np.isnan(w[1])
        else:
            np.testing.assert_allclose(g[1], w[1], rtol=1e-15, err_msg=kind)


def _key_values(dtype, rng, n):
    if dtype == "u64_sparse":
        return rng.integers(0, 2**64 - 1, 40, dtype=np.uint64)[rng.integers(0, 40, n)]
    if dtype == "i64_sparse":
        return rng.integers(-2**63, 2**63 - 1, 40, dtype=np.int64)[rng.integers(0, 40, n)]
    if dtype == "f64_fraction":
        return np.round(rng.normal(size=n), 1)
    if dtype == "datetime":
        return (np.datetime64("2020-01-01") + rng.integers(0, 30, n)
                .astype("timedelta64[D]")).astype("datetime64[ns]")
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype == "f32":
        return rng.integers(-20, 20, n).astype(np.float32)
    return rng.integers(0, 60, n).astype(dtype)


@pytest.mark.parametrize("key", ["int8", "uint8", "uint16", "uint32", "int64", "u64_sparse",
                                 "i64_sparse", "bool", "f32", "f64_fraction", "datetime"])
@pytest.mark.parametrize("lane", ["onehot_or_sort", "sort_or_generic"])
def test_key_dtypes_decode_like_the_reference(key, lane):
    """Every key dtype round-trips through each lane's key coding: the
    one-hot lane where the key's codes fit 11 bits, the code-sort lane, and
    the generic engine for non-integral floats."""
    rng = np.random.default_rng(12)
    n = 4000
    df = pd.DataFrame({"k": _key_values(key, rng, n),
                       "v": rng.normal(size=n).astype(np.float32),
                       "x": rng.normal(size=n)})
    specs = ([("v", "sum", "s"), ("", "size", "n")] if lane == "onehot_or_sort"
             else [("x", "sum", "s"), ("x", "min", "lo"), ("", "size", "n")])
    raggs, taggs = _aggs(specs)
    want = rgb.groupby_aggregate(ct.Table.from_pandas(df), ["k"], raggs).to_pandas()
    got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["k"],
                                taggs).to_pandas()
    assert_same(got, want, {"s": 1e-5} if lane == "onehot_or_sort" else None)


def test_all_true_bool_key_decodes_as_true():
    """A bool key whose values are all True has vmin = 1; its code 0 must
    decode back to True (the reference's lanes decode it as False)."""
    df = pd.DataFrame({"k": np.array([True, True, True]), "v": np.array([1.0, 2.0, 3.0])})
    for specs in ([("v", "sum", "s")], [("v", "min", "s")]):
        got = tgb.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["k"],
                                    _aggs(specs)[1]).to_pandas()
        assert got["k"].tolist() == [True]


@pytest.mark.parametrize("plan", ["blocks", "pieces"])
def test_group_sums_add_each_groups_own_rows(plan):
    """GroupSums over groups of 1 to 5,000 rows (inside one block, across
    blocks, many blocks; small on average for the blocks plan, large for
    the pieces plan): each float sum within 16·eps·Σ_group|x| of the exact
    sum, the same bits on a second call, integer sums exact."""
    rng = np.random.default_rng(9)
    lengths = (np.r_[rng.integers(1, 4, 300), rng.integers(15, 40, 50), 5000, 1, 17]
               if plan == "blocks" else np.r_[rng.integers(300, 3000, 20), 1, 2, 5000])
    rng.shuffle(lengths)
    n = int(lengths.sum())
    x = rng.normal(size=n) * 10.0 ** rng.integers(-3, 7, n)
    seg = np.repeat(np.arange(len(lengths)), lengths)
    sums = tfast.GroupSums(torch.from_numpy(np.r_[seg, [len(lengths)] * 7]),
                           torch.from_numpy(lengths), n)
    xt = torch.from_numpy(np.r_[x, np.full(7, 1e300)])  # rows past n are ignored
    got = sums(xt).numpy()
    assert sums._plan[0] == plan
    assert np.array_equal(got, sums(xt).numpy())
    starts = np.r_[0, np.cumsum(lengths)[:-1]]
    exact = np.array([math.fsum(x[s:s + k]) for s, k in zip(starts, lengths)])
    bound = 16 * np.finfo(np.float64).eps * np.add.reduceat(np.abs(x), starts)
    assert (np.abs(got - exact) <= bound).all()
    xi = torch.from_numpy(rng.integers(-2**40, 2**40, n + 7))
    np.testing.assert_array_equal(sums(xi).numpy(),
                                  np.add.reduceat(xi.numpy()[:n], starts))
