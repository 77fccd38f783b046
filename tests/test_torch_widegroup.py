"""The wide-key groupby lane (``ops/widegroup.py``) against cudf_tpu's.

Twins of ``tests/test_sparse_keys.py``'s widegroup tests: the same seeded
frames go through ``cudf_tpu.ops.widegroup.wide_groupby`` (JAX on the CPU),
the port's on ``device="cpu"`` and pandas. Keys, counts, group order,
null masks and first/last/argmin/argmax are exact; float aggregates are
held to rtol 1e-6, atol 1e-8, the reference test's tolerance. ``op_widths``
equals the reference's for every dtype, and both lanes refuse the same
plans.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import fastgroup as rfast
from cudf_tpu.ops import groupby as rgb
from cudf_tpu.ops import widegroup as rwide
from cudf_tpu.ops.unaryop import nans_to_nulls as r_nans_to_nulls

import cudf_tpu_torch as tt
from cudf_tpu_torch.core.lists import ListColumn
from cudf_tpu_torch.core.structs import StructColumn
from cudf_tpu_torch.ops import fastgroup as tfast
from cudf_tpu_torch.ops import groupby as tgb
from cudf_tpu_torch.ops import widegroup as twide
from cudf_tpu_torch.ops.unaryop import nans_to_nulls as t_nans_to_nulls

N = 20_000
RTOL, ATOL = 1e-6, 1e-8


def _tables(df):
    return ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")


def _aggs(specs):
    return ([rgb.AggSpec(*s) for s in specs], [tgb.AggSpec(*s) for s in specs])


def assert_same(got: pd.DataFrame, want: pd.DataFrame):
    """Row for row: non-float columns exactly equal, floats to RTOL/ATOL."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want), (len(got), len(want))
    for name in want.columns:
        g, w = got[name].to_numpy(), want[name].to_numpy()
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=RTOL, atol=ATOL, equal_nan=True,
                                       err_msg=name)
        else:
            gn, wn = pd.isna(g), pd.isna(w)
            np.testing.assert_array_equal(gn, wn, err_msg=name)
            np.testing.assert_array_equal(g[~gn], w[~wn], err_msg=name)


def _both(df, keys, specs, dropna=True):
    """(port, reference) wide_groupby answers as pandas frames."""
    rt, tt_ = _tables(df)
    raggs, taggs = _aggs(specs)
    want = rwide.wide_groupby(rt, keys, raggs, dropna)
    got = twide.wide_groupby(tt_, keys, taggs, dropna)
    assert want is not None and got is not None
    return got.to_pandas(), want.to_pandas()


def test_wide_lane_applies_to_sparse_i64():
    rng = np.random.default_rng(7)
    df = pd.DataFrame({"k": rng.integers(0, 2**62, N, dtype=np.int64), "v": np.ones(N)})
    rt, tt_ = _tables(df)
    assert rfast.plan_codes((rt["k"],), max_bits=40) is None
    assert tfast.plan_codes([tt_["k"]], max_bits=40) is None
    got, want = _both(df, ["k"], [("v", "sum", "s")])
    assert_same(got, want)
    assert got["k"].is_monotonic_increasing and len(got) == df["k"].nunique()


AGG_KINDS = [
    ["mean", "sum", "count"], ["min", "max", "size"],
    ["first", "last"], ["var", "std"], ["argmin", "argmax"],
    ["any", "all"], ["product", "sum_of_squares"], ["m2"],
]


def _pandas_agg(df, kd):
    gb = df.groupby("k")
    if kd == "size":
        return gb.size()
    if kd == "m2":
        return gb["v"].agg(lambda s: ((s - s.mean()) ** 2).sum())
    if kd == "sum_of_squares":
        return gb["v"].agg(lambda s: (s ** 2).sum())
    if kd in ("argmin", "argmax"):
        return getattr(gb["v"], "idxmin" if kd == "argmin" else "idxmax")()
    if kd in ("any", "all"):
        return df.assign(b=df["v"].astype(bool)).groupby("k")["b"].agg(kd)
    if kd == "product":
        return gb["v"].prod()
    return getattr(gb["v"], kd)()


@pytest.mark.parametrize("kinds", AGG_KINDS, ids=["-".join(k) for k in AGG_KINDS])
def test_widegroup_aggs_sparse_i64(kinds):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 2**62, N // 8, dtype=np.int64)
    df = pd.DataFrame({"k": base[rng.integers(0, len(base), N)],
                       "v": rng.normal(size=N)})
    got, want = _both(df, ["k"], [("v", kd, f"o{i}") for i, kd in enumerate(kinds)])
    assert_same(got, want)
    for i, kd in enumerate(kinds):
        exp = _pandas_agg(df, kd).reset_index(drop=True)
        np.testing.assert_allclose(got[f"o{i}"].astype(float).to_numpy(),
                                   exp.astype(float).to_numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=kd)


def test_widegroup_float_keys_and_multikey():
    rng = np.random.default_rng(7)
    kf = rng.normal(size=N // 4) * 1e12
    df = pd.DataFrame({
        "a": np.repeat(kf, 4),
        "b": np.tile(rng.integers(-2**60, 2**60, 4, dtype=np.int64), N // 4),
        "v": rng.normal(size=N),
    })
    got, want = _both(df, ["a", "b"], [("v", "mean", "m")])
    assert_same(got, want)
    exp = df.groupby(["a", "b"], as_index=False).agg(m=("v", "mean"))
    pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=RTOL)


def test_widegroup_nullable_keys():
    rng = np.random.default_rng(7)
    kv = (rng.normal(size=N // 4) * 1e12).round()
    kv[::11] = np.nan
    df = pd.DataFrame({"k": np.repeat(kv, 4), "v": rng.normal(size=N)})
    rt, tt_ = _tables(df)
    rt = ct.Table({"k": r_nans_to_nulls(rt["k"]), "v": rt["v"]})
    tt_ = tt.Table({"k": t_nans_to_nulls(tt_["k"]), "v": tt_["v"]})
    raggs, taggs = _aggs([("v", "mean", "m"), ("v", "first", "f")])
    rows = {}
    for dropna in (False, True):
        want = rwide.wide_groupby(rt, ["k"], raggs, dropna).to_pandas()
        got = twide.wide_groupby(tt_, ["k"], taggs, dropna).to_pandas()
        assert_same(got, want)
        exp = df.groupby("k", dropna=dropna, as_index=False).agg(
            m=("v", "mean"), f=("v", "first"))
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=RTOL)
        rows[dropna] = len(got)
    assert rows[True] == rows[False] - 1
    assert pd.isna(got["k"]).sum() == 0


DISPATCH_SHAPES = {
    # one sparse key spans at most 2^62 codes: the single-word sort lane
    # answers it first, in both packages
    "one_sparse_key": (["k"], 0),
    "two_sparse_keys": (["k", "k2"], 1),
    "float_key": (["f"], 1),
}


@pytest.mark.parametrize("shape", list(DISPATCH_SHAPES))
def test_widegroup_dispatched_from_groupby_aggregate(shape):
    keys, wide_answers = DISPATCH_SHAPES[shape]
    rng = np.random.default_rng(7)
    k = rng.integers(0, 2**62, N, dtype=np.int64)
    df = pd.DataFrame({"k": np.repeat(k[: N // 4], 4),
                       "k2": rng.integers(0, 2**62, 8, dtype=np.int64)[rng.integers(0, 8, N)],
                       "f": np.repeat(rng.normal(size=N // 4) * 1e9, 4),
                       "v": rng.normal(size=N)})
    raggs, taggs = _aggs([("v", "mean", "m"), ("v", "var", "s2")])
    rt, tt_ = _tables(df)
    before = twide.wide_groupby.launches
    got = tgb.groupby_aggregate(tt_, keys, taggs).to_pandas()
    assert twide.wide_groupby.launches == before + wide_answers
    assert_same(got, rgb.groupby_aggregate(rt, keys, raggs).to_pandas())
    exp = df.groupby(keys, as_index=False).agg(m=("v", "mean"), s2=("v", "var"))
    pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=RTOL)


def _typed_frame(rng, n):
    """A column of every dtype the wide lane keys on, with nulls where
    pandas can hold them."""
    nulls = rng.random(n) < 0.1
    cat = np.array(["ab", "c", "de", "f", "gh"], object)
    return pd.DataFrame({
        "b": rng.random(n) < 0.5,
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "i16": rng.integers(-3, 3, n).astype(np.int16),
        "i32": pd.arrays.IntegerArray(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                                      nulls),
        "i64": rng.integers(-2**62, 2**62, n, dtype=np.int64) // 1024 * 1024,
        "u8": rng.integers(0, 4, n).astype(np.uint8),
        "u32": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "u64": rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2),
        "f32": np.where(rng.random(n) < 0.05, np.nan,
                        np.where(rng.random(n) < 0.05, -0.0,
                                 rng.normal(size=n).astype(np.float32) * 1e20)).astype(np.float32),
        "f64": np.where(rng.random(n) < 0.05, np.nan, rng.normal(size=n) * 1e300),
        "ts": (np.datetime64("2020-01-01", "ns")
               + rng.integers(0, 10**15, n).astype("timedelta64[ns]")),
        "td": rng.integers(-10**12, 10**12, n).astype("timedelta64[ns]"),
        "s": np.where(nulls, None, cat[rng.integers(0, len(cat), n)]),
    })


def test_op_widths_equal_the_reference_for_every_dtype():
    rng = np.random.default_rng(3)
    df = _typed_frame(rng, 64)
    rt, tt_ = _tables(df)
    for name in df.columns:
        assert twide.op_widths(tt_[name]) == rwide.op_widths(rt[name]), name
        rm = rt[name].with_validity(rt[name].valid_mask())
        tm = tt_[name].with_validity(tt_[name].valid_mask())
        assert twide.op_widths(tm) == rwide.op_widths(rm), name
    for ndict in (0, 1, 2, 3, 4, 1000, 1025):
        vals = np.array([f"v{i:05d}" for i in range(ndict)], object)
        col = pd.DataFrame({"s": vals})
        r, t = _tables(col)
        assert twide.op_widths(t["s"]) == rwide.op_widths(r["s"]), ndict
    from cudf_tpu.ops import decimal as rdec
    from cudf_tpu_torch.ops import decimal as tdec

    x = np.array([1.25, -3.5, 7.0])
    for bits in (32, 64):
        rc = rdec.from_floats(ct.Column.from_numpy(x), -2, bits)
        tc = tdec.from_floats(tt.Column.from_numpy(x, device="cpu"), -2, bits)
        assert twide.op_widths(tc) == rwide.op_widths(rc), bits


def test_op_widths_refuse_lists_and_structs():
    lists = ListColumn.from_pylist([[1, 2], [], None], device="cpu")
    structs = StructColumn.from_pydict_rows([{"a": 1}, None], device="cpu")
    assert twide.op_widths(lists) is None and twide.op_widths(structs) is None


@pytest.mark.parametrize("keys", [["b", "i8", "u8"], ["i16", "i32"], ["u32", "f32"],
                                  ["f64"], ["i64", "u64"], ["ts", "td"], ["s", "f64"],
                                  ["i32", "s", "u64"]])
@pytest.mark.parametrize("dropna", [True, False])
def test_every_key_dtype_equals_the_reference(keys, dropna):
    rng = np.random.default_rng(11)
    df = _typed_frame(rng, 4000)
    df = df.iloc[rng.integers(0, 1000, 4000)].reset_index(drop=True)  # repeated keys
    df["v"] = rng.normal(size=len(df))
    specs = [("v", "sum", "vs"), ("v", "first", "vf"), ("v", "argmax", "am"),
             ("", "size", "n")]
    got, want = _both(df, keys, specs, dropna)
    assert_same(got, want)
    gen = tgb.generic_groupby(tt.Table.from_pandas(df, device="cpu"), keys,
                              _aggs(specs)[1], dropna).to_pandas()
    assert_same(got, gen)


def test_refused_in_the_same_cases():
    rng = np.random.default_rng(5)
    n = 200
    df = pd.DataFrame({
        "x": rng.normal(size=n), "y": rng.normal(size=n), "z": rng.normal(size=n),
        "i": rng.integers(0, 2**62, n, dtype=np.int64), "v": rng.normal(size=n),
    })
    rt, tt_ = _tables(df)
    rt = ct.Table({c: r_nans_to_nulls(rt[c]) for c in df.columns})
    tt_ = tt.Table({c: t_nans_to_nulls(tt_[c]) for c in df.columns})
    cases = [
        (["x", "y"], [("v", "median", "m")]),        # an agg outside _SUPPORTED
        (["i"], [("v", "nunique", "u")]),
        (["x", "y", "i"], [("v", "sum", "s")]),      # 1 + 68 + 68 + 64 = 201 bits
        (["x", "y", "z"], [("v", "sum", "s")]),      # 1 + 3 * 68 = 205 bits
        (["x", "y"], [("v", "sum", "s")]),           # 137 bits: accepted
        (["i", "i", "x"], [("v", "sum", "s")]),      # 1 + 64 + 64 + 68 = 197 bits
    ]
    for keys, specs in cases:
        raggs, taggs = _aggs(specs)
        want = rwide.wide_groupby(rt, keys, raggs, True)
        got = twide.wide_groupby(tt_, keys, taggs, True)
        assert (got is None) == (want is None), keys
        if got is not None:
            assert_same(got.to_pandas(), want.to_pandas())
    assert twide.MAX_WORDS == rwide.MAX_WORDS == 3


def test_empty_and_all_inactive_tables():
    df = pd.DataFrame({"k": np.array([], np.int64), "v": np.array([], np.float64)})
    got, want = _both(df, ["k"], [("v", "sum", "s"), ("", "size", "n")])
    assert len(got) == len(want) == 0
    df = pd.DataFrame({"k": pd.arrays.IntegerArray(np.zeros(5, np.int64),
                                                   np.ones(5, bool)),
                       "v": np.arange(5.0)})
    got, want = _both(df, ["k"], [("v", "sum", "s")], dropna=True)
    assert len(got) == len(want) == 0
    got, want = _both(df, ["k"], [("v", "sum", "s")], dropna=False)
    assert_same(got, want)
    assert len(got) == 1 and got["s"][0] == 10.0
