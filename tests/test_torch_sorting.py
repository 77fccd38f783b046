"""The port's sorting, rank, search and merge against cudf_tpu's.

Same numpy inputs, made from a seed, become columns of both packages (the
port on the CPU). Everything here is exact: permutations over the real
rows, ranks (an average rank is a half-integer), search positions and
merged rows. Null rows hold 0 under the null, as ingest leaves them, and
f32 keys no -0: on those two points the reference's ``sorted_order``
departs from its own engine sort, and the port follows the engine sort
(the last two tests pin both).
"""
import zlib

import numpy as np
import pandas as pd
import pytest

from cudf_tpu.core.column import Column as RColumn
from cudf_tpu.core.table import Table as RTable
from cudf_tpu.ops import merge as rmerge
from cudf_tpu.ops import search as rsearch
from cudf_tpu.ops import sorting as rsort

from cudf_tpu_torch.core.column import Column as TColumn
from cudf_tpu_torch.core.table import Table as TTable
from cudf_tpu_torch.ops import merge as tmerge
from cudf_tpu_torch.ops import search as tsearch
from cudf_tpu_torch.ops import sorting as tsort

# tests/test_dtype_cartesian.py's key dtypes
KEY_DTYPES = ["int8", "int16", "int32", "int64", "uint32", "float32",
              "float64", "bool", "str", "datetime64[ns]"]
N = 300


def _seed(s):
    return zlib.crc32(s.encode()) % 2**31


def _key(dtype, n, rng, nulls=True):
    """(values, validity): few distinct values (ties), 10% nulls with 0
    under them; floats also hold NaN, 0 and +-inf, f64 also -0."""
    if dtype == "str":
        v = np.array(["aa", "b", "cc", "", "e"], object)[rng.integers(0, 5, n)]
    elif dtype == "bool":
        v = rng.random(n) < 0.5
    elif dtype == "datetime64[ns]":
        v = (np.datetime64("2021-01-01", "ns")
             + rng.integers(0, 5, n).astype("timedelta64[D]"))
    elif dtype.startswith("float"):
        special = [-0.0, 0.0] if dtype == "float64" else [0.0]
        v = rng.choice(np.array([-3, -1.5, 2, np.inf, -np.inf, np.nan] + special), n)
        v = v.astype(dtype)
    elif dtype.startswith("u"):
        v = rng.integers(0, 7, n).astype(dtype)
    else:
        v = rng.integers(-3, 4, n).astype(dtype)
    valid = rng.random(n) >= 0.1 if nulls else None
    if nulls:
        v = v.copy()
        v[~valid] = None if dtype == "str" else np.zeros((), v.dtype)
        if dtype == "str":
            valid = None  # None marks a string null
    return v, valid


def _cols(values, valid):
    return (RColumn.from_numpy(values, valid),
            TColumn.from_numpy(values, valid, device="cpu"))


def _perm(p, n):
    return np.asarray(p)[:n].astype(np.int64)


@pytest.mark.parametrize("nulls_last", [True, False])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", KEY_DTYPES)
def test_sorted_order_equals_reference(dtype, descending, nulls_last):
    rng = np.random.default_rng(_seed(dtype))
    rc, tc = _cols(*_key(dtype, N, rng))
    want = rsort.sorted_order([rc], descending, nulls_last)
    got = tsort.sorted_order([tc], descending, nulls_last)
    np.testing.assert_array_equal(_perm(got, N), _perm(want, N))


@pytest.mark.parametrize("k1,k2", [("float64", "int32"), ("str", "float32"),
                                   ("datetime64[ns]", "bool"), ("int64", "uint32")])
def test_sort_by_key_two_keys_equals_reference(k1, k2):
    """bench.py's sort shape: two keys with nulls, mixed directions and
    null placements, a payload column carried along."""
    rng = np.random.default_rng(_seed(k1 + k2))
    (r1, t1), (r2, t2) = _cols(*_key(k1, N, rng)), _cols(*_key(k2, N, rng))
    pay = np.arange(N)
    rt = RTable({"a": r1, "b": r2, "p": RColumn.from_numpy(pay)})
    tt = TTable({"a": t1, "b": t2, "p": TColumn.from_numpy(pay, device="cpu")})
    for desc, nl in (([False, False], [True, True]), ([True, False], [False, True]),
                     ([False, True], [True, False])):
        want = rsort.sort_by_key(rt, ["a", "b"], desc, nl).to_pandas()
        got = tsort.sort_by_key(tt, ["a", "b"], desc, nl).to_pandas()
        pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_sort_of_an_empty_table_and_a_sliced_one():
    e = np.array([], np.float64)
    rt, tt = RTable({"k": RColumn.from_numpy(e)}), TTable({"k": TColumn.from_numpy(e, device="cpu")})
    assert tsort.sort_by_key(tt, ["k"]).num_rows == rsort.sort_by_key(rt, ["k"]).num_rows == 0
    rng = np.random.default_rng(3)
    v, valid = _key("float64", 500, rng)
    rc, tc = _cols(v, valid)
    rt, tt = RTable({"k": rc}).slice(100, 250), TTable({"k": tc}).slice(100, 250)
    pd.testing.assert_frame_equal(tsort.sort_by_key(tt, ["k"], True).to_pandas(),
                                  rsort.sort_by_key(rt, ["k"], True).to_pandas())


@pytest.mark.parametrize("pct", [False, True])
@pytest.mark.parametrize("method", ["average", "min", "max", "first", "dense"])
@pytest.mark.parametrize("dtype", ["int32", "float64", "str"])
def test_rank_equals_reference(dtype, method, pct):
    rng = np.random.default_rng(_seed(dtype + method))
    v, valid = _key(dtype, N, rng)
    if dtype == "int32":
        v = v + 10  # no 0 at either end (see the padding test below)
    elif dtype == "float64":
        v = np.where(np.isnan(v) | (v == 0), 1.0, v)
    rc, tc = _cols(v, valid)
    for desc in (False, True):
        want = rsort.rank(rc, method, desc, pct).to_pandas()
        got = tsort.rank(tc, method, desc, pct).to_pandas()
        pd.testing.assert_series_equal(got, want, check_dtype=False)


def test_rank_padding_never_joins_the_last_group():
    """The reference sorts padding rows (value 0) after the real rows and
    lets them join the last group when its value is 0: max rank 128 for a
    4-row column. The port marks the first padding row a group start, so
    it gives pandas' ranks."""
    v = np.array([-3, 0, -1, 0], np.int64)
    tc = TColumn.from_numpy(v, device="cpu")
    for method in ("max", "average", "min", "dense", "first"):
        want = pd.Series(v).rank(method=method).to_numpy()
        np.testing.assert_array_equal(tsort.rank(tc, method).to_numpy(), want)
    assert rsort.rank(RColumn.from_numpy(v), "max").to_numpy().max() == 128


def test_top_k_equals_reference():
    rng = np.random.default_rng(11)
    k, p = rng.integers(0, 50, N), rng.normal(size=N)
    rt = RTable({"k": RColumn.from_numpy(k), "p": RColumn.from_numpy(p)})
    tt = TTable({"k": TColumn.from_numpy(k, device="cpu"),
                 "p": TColumn.from_numpy(p, device="cpu")})
    for largest in (True, False):
        pd.testing.assert_frame_equal(tsort.top_k(tt, 7, ["k"], largest).to_pandas(),
                                      rsort.top_k(rt, 7, ["k"], largest).to_pandas())


@pytest.mark.parametrize("dtype", ["int64", "float32", "str", "datetime64[ns]"])
def test_searchsorted_and_contains_equal_reference(dtype):
    rng = np.random.default_rng(_seed("search" + dtype))
    hv, hvalid = _key(dtype, 200, rng)
    nv, nvalid = _key(dtype, 150, rng)
    (rh, th), (rn, tn) = _cols(hv, hvalid), _cols(nv, nvalid)
    if dtype == "str":  # one dictionary for haystack and needles
        from cudf_tpu.ops.strings import unify_dictionaries as ru
        from cudf_tpu_torch.ops.strings import unify_dictionaries as tu

        rh, rn = ru([rh, rn])
        th, tn = tu([th, tn])
    rs_, ts_ = rsort.sort_column(rh), tsort.sort_column(th)
    for side in ("left", "right"):
        want = rsearch.searchsorted(rs_, rn, side).to_numpy()
        got = tsearch.searchsorted(ts_, tn, side).to_numpy()
        np.testing.assert_array_equal(got, want)
    want = rsearch.contains(rh, rn).to_pandas()
    got = tsearch.contains(th, tn).to_pandas()
    pd.testing.assert_series_equal(got, want)


def test_merge_sorted_equals_reference():
    rng = np.random.default_rng(5)
    parts = []
    for n in (40, 0, 75):
        k = np.sort(rng.integers(0, 20, n))[::-1].copy()
        parts.append((k, np.arange(n) + 1000 * len(parts)))
    rts = [RTable({"k": RColumn.from_numpy(k), "v": RColumn.from_numpy(v)}) for k, v in parts]
    tts = [TTable({"k": TColumn.from_numpy(k, device="cpu"),
                   "v": TColumn.from_numpy(v, device="cpu")}) for k, v in parts]
    want = rmerge.merge_sorted(rts, ["k"], descending=True).to_pandas()
    got = tmerge.merge_sorted(tts, ["k"], descending=True).to_pandas()
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_segmented_sort_equals_reference(dtype):
    rng = np.random.default_rng(_seed("seg" + dtype))
    v, valid = _key(dtype, N, rng)
    rc, tc = _cols(v, valid)
    offsets = np.array([0, 37, 37, 120, 250])
    for desc in (False, True):
        want = rsort.segmented_sorted_order([rc], offsets, desc)
        got = tsort.segmented_sorted_order([tc], offsets, desc)
        np.testing.assert_array_equal(_perm(got, N), _perm(want, N))
    pay = np.arange(N)
    rt = RTable({"k": rc, "p": RColumn.from_numpy(pay)})
    tt = TTable({"k": tc, "p": TColumn.from_numpy(pay, device="cpu")})
    pd.testing.assert_frame_equal(
        tsort.segmented_sort_by_key(tt, ["k"], offsets, False, False).to_pandas(),
        rsort.segmented_sort_by_key(rt, ["k"], offsets, False, False).to_pandas())


def test_null_rows_keep_their_order_whatever_lies_under_them():
    """Nulls compare equal (cuDF, pandas, the reference's engine sort), so a
    stable sort keeps them in row order. The reference's ``sorted_order``
    orders them by the payload hidden under the null."""
    v = np.array([5, 3, 1, 2], np.int64)
    valid = np.array([True, False, True, False])
    got = tsort.sorted_order([TColumn.from_numpy(v, valid, device="cpu")])
    np.testing.assert_array_equal(_perm(got, 4), [2, 0, 1, 3])
    rt = RTable({"k": RColumn.from_numpy(v, valid), "p": RColumn.from_numpy(np.arange(4))})
    np.testing.assert_array_equal(rsort.sort_by_key(rt, ["k"]).to_pandas()["p"], [2, 0, 1, 3])
    np.testing.assert_array_equal(_perm(rsort.sorted_order([RColumn.from_numpy(v, valid)]), 4),
                                  [2, 0, 3, 1])


def test_f32_minus_zero_equals_plus_zero():
    """-0.0 == +0.0 in a sort (cuDF, pandas, the reference's f64 codes);
    the reference's f32 order codes put -0 first."""
    v = np.array([0.0, -0.0, 1.5, 0.0, -0.0], np.float32)
    got = tsort.sorted_order([TColumn.from_numpy(v, device="cpu")])
    want = pd.Series(v).sort_values(kind="stable").index.to_numpy()
    np.testing.assert_array_equal(_perm(got, 5), want)
    np.testing.assert_array_equal(_perm(rsort.sorted_order([RColumn.from_numpy(v)]), 5),
                                  [1, 4, 0, 3, 2])
