"""The port's columnar core, compaction, gather and sort against cudf_tpu.

Same numpy/pandas inputs, made from a seed, go through ``cudf_tpu`` and
``cudf_tpu_torch`` (on the CPU). Everything here is exact.
"""
import subprocess
import sys
from dataclasses import astuple

import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp
import torch

import cudf_tpu as ct
from cudf_tpu.core import stats as rstats
from cudf_tpu.ops import copying as rcopy
from cudf_tpu.ops import rowcodes as rrow
from cudf_tpu.ops import sortprim as rsort
from cudf_tpu.ops import stream_compaction as rsc

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import stats as tstats
from cudf_tpu_torch.core.column import Column as TColumn
from cudf_tpu_torch.ops import copying as tcopy
from cudf_tpu_torch.ops import rowcodes as trow
from cudf_tpu_torch.ops import sortprim as tsort
from cudf_tpu_torch.ops import stream_compaction as tsc


def export(tbl):
    """A cudf_tpu Table as ``Table.from_host_buffers`` input."""
    from cudf_tpu.core import dtypes as rdt

    out = {}
    for name, c in tbl:
        dt = "string" if c.dtype.is_string else rdt.to_numpy(c.dtype).name
        if c.dtype.is_temporal:
            dt = rdt.to_numpy(c.dtype).str.lstrip("<>|=")
        out[name] = {"dtype": dt, "data": np.asarray(c.data),
                     "validity": None if c.validity is None else np.asarray(c.validity),
                     "length": c.length, "dictionary": c.dictionary}
    return out


def _frame(kind, n, rng):
    if kind == "empty":
        return pd.DataFrame({"i": np.array([], np.int64), "f": np.array([], np.float32),
                             "s": np.array([], object)})
    nulls = rng.random(n) < 0.2
    f64 = rng.normal(size=n)
    f64[rng.random(n) < 0.1] = np.nan
    f32 = rng.normal(size=n).astype(np.float32)
    f32[::13] = np.nan
    strs = np.array(["pear", "apple", "fig", "", "kiwi"], object)[rng.integers(0, 5, n)]
    strs[nulls] = None
    cols = {
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "i16": rng.integers(-3000, 3000, n).astype(np.int16),
        "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "u16": rng.integers(0, 65535, n).astype(np.uint16),
        "u32": rng.integers(0, 2**32 - 1, n).astype(np.uint32),
        "u64": rng.integers(0, 2**63, n).astype(np.uint64) * np.uint64(2),
        "f32": f32,
        "f64": f64,
        "b": rng.random(n) < 0.5,
        "s": strs,
        "ni": pd.arrays.IntegerArray(rng.integers(-5, 5, n), nulls),
        "nf": pd.arrays.FloatingArray(rng.normal(size=n), nulls),
        "nb": pd.arrays.BooleanArray(rng.random(n) < 0.5, nulls),
        "ts": (np.datetime64("2024-01-01") + rng.integers(0, 10**6, n)
               .astype("timedelta64[s]")).astype("datetime64[ns]"),
    }
    if kind == "all_null":
        cols = {"ni": pd.arrays.IntegerArray(np.zeros(n, np.int64), np.ones(n, bool)),
                "s": np.array([None] * n, object), "f64": np.full(n, np.nan)}
    return pd.DataFrame(cols)


FRAMES = ["mixed", "empty", "all_null", "tiny"]


def _pair(kind, seed=0):
    rng = np.random.default_rng(seed)
    df = _frame(kind, 5 if kind == "tiny" else 3000, rng)
    return df, ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")


def test_port_imports_no_jax_and_nothing_of_cudf_tpu():
    code = (
        "import sys, pkgutil, importlib, cudf_tpu_torch\n"
        "for m in pkgutil.walk_packages(cudf_tpu_torch.__path__, 'cudf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cudf_tpu' or m.startswith('cudf_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_ingest_defaults_to_cuda():
    df = pd.DataFrame({"a": [1, 2]})
    if torch.cuda.is_available():
        assert tt.Table.from_pandas(df)["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.Table.from_pandas(df)


@pytest.mark.parametrize("kind", FRAMES)
def test_from_pandas_roundtrip_matches_reference(kind):
    df, r, t = _pair(kind)
    assert t.names == r.names
    for name, rc in r:
        tc = t[name]
        assert (tc.dtype.kind, tc.dtype.bits, tc.dtype.param) == \
            (rc.dtype.kind, rc.dtype.bits, rc.dtype.param), name
        assert tc.capacity == rc.capacity and tc.length == rc.length
        np.testing.assert_array_equal(tc.data[: tc.length].numpy(),
                                      np.asarray(rc.data)[: rc.length])
        assert (tc.validity is None) == (rc.validity is None), name
        if rc.dictionary is not None:
            np.testing.assert_array_equal(tc.dictionary, rc.dictionary)
    pd.testing.assert_frame_equal(t.to_pandas(), r.to_pandas())


@pytest.mark.parametrize("kind", ["mixed", "all_null"])
def test_from_host_buffers_carries_the_padded_layout(kind):
    _, r, _ = _pair(kind)
    t = tt.Table.from_host_buffers(export(r), device="cpu")
    for name, rc in r:
        np.testing.assert_array_equal(t[name].data.numpy(), np.asarray(rc.data))
    pd.testing.assert_frame_equal(t.to_pandas(), r.to_pandas())


@pytest.mark.parametrize("kind", FRAMES)
@pytest.mark.parametrize("keys,thresh", [(None, None), (["ni", "s"], None),
                                         (["ni", "s"], 1), (["f64"], None)])
def test_drop_nulls_matches_reference(kind, keys, thresh):
    _, r, t = _pair(kind)
    if keys is not None and not set(keys) <= set(r.names):
        keys = [n for n in keys if n in r.names] or None
    want = rsc.drop_nulls(r, keys, thresh).to_pandas()
    got = tsc.drop_nulls(t, keys, thresh)
    pd.testing.assert_frame_equal(got.to_pandas(), want)
    for c in got.columns:
        assert c.capacity == tt.core.column.bucket_capacity(c.length)


@pytest.mark.parametrize("kind", ["mixed", "tiny", "empty"])
def test_apply_boolean_mask_matches_reference(kind):
    df, r, t = _pair(kind)
    rng = np.random.default_rng(5)
    n = len(df)
    m = rng.random(n) < 0.4
    mv = rng.random(n) < 0.8
    rmask = ct.Column.from_numpy(m, validity=mv)
    tmask = TColumn.from_numpy(m, validity=mv, device="cpu")
    want = rsc.apply_boolean_mask(r, rmask).to_pandas()
    pd.testing.assert_frame_equal(tsc.apply_boolean_mask(t, tmask).to_pandas(), want)


def test_compaction_keeps_the_source_stats():
    """After drop_nulls a key keeps has_null=True (its code width keeps the
    null code), as the reference's stats propagation does on a table of at
    most MAX_PAYLOADS buffers (a wider one takes its gather path, which
    recomputes the stats)."""
    _, r, t = _pair("mixed")
    r, t = r.select(["ni", "f32", "s"]), t.select(["ni", "f32", "s"])
    rd, td = rsc.drop_nulls(r, ["ni"]), tsc.drop_nulls(t, ["ni"])
    assert astuple(tstats.compute_stats(td["ni"])) == astuple(rstats.compute_stats(rd["ni"]))
    assert tstats.compute_stats(td["ni"]).has_null


@pytest.mark.parametrize("name", ["i8", "i16", "i32", "i64", "u8", "u16", "u32", "u64",
                                  "f32", "f64", "b", "s", "ni", "nf", "nb", "ts"])
def test_compute_stats_matches_reference(name):
    _, r, t = _pair("mixed")
    want = rstats.compute_stats(r[name])
    got = tstats.compute_stats(t[name])
    assert astuple(got) == astuple(want)


def _float_specials(dtype, n, rng):
    """Normal values plus 0, -0, +-inf, +-NaN and the smallest normals.
    Subnormals are left out: XLA flushes them to zero, the port does not
    (see test_subnormals_stay_distinct_from_zero)."""
    x = rng.normal(size=n).astype(dtype)
    tiny = np.finfo(dtype).tiny
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, tiny, -tiny,
                         -5.0, 5.0], dtype)
    x[rng.integers(0, n, 40)] = specials[rng.integers(0, len(specials), 40)]
    x[:len(specials)] = specials
    return x


def _sort_columns(rng, n):
    nulls = rng.random(n) < 0.15
    ints = rng.integers(-50, 50, n)
    return {
        "i32": (ints.astype(np.int32), None),
        "i64": (rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64), nulls),
        "u32": (rng.integers(0, 2**32 - 1, n).astype(np.uint32), None),
        "u64": (rng.integers(0, 2**64 - 1, n, dtype=np.uint64), nulls),
        "b": (rng.random(n) < 0.5, nulls),
        "f32": (_float_specials(np.float32, n, rng), nulls),
        "f64": (_float_specials(np.float64, n, rng), None),
        "s": (np.array(["b", "a", "c", "aa"], object)[rng.integers(0, 4, n)], nulls),
        "dup": (rng.integers(0, 3, n).astype(np.int16), nulls),
    }


@pytest.mark.parametrize("name", ["i32", "i64", "u32", "u64", "b", "f32", "f64", "s"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_last", [False, True])
def test_multisort_perm_matches_reference(name, descending, nulls_last):
    """A stable sort by (dup, name) codes: the permutation, padding rows
    included, equals the reference's over its u32 operands."""
    rng = np.random.default_rng(11)
    n = 700
    cols = _sort_columns(rng, n)
    r, t = [], []
    for key in ("dup", name):
        arr, valid = cols[key]
        r.append(ct.Column.from_numpy(arr, validity=valid))
        t.append(TColumn.from_numpy(arr, validity=valid, device="cpu"))
    desc, nl = [False, descending], [True, nulls_last]
    rops, _ = rrow.sort_operands(r, desc, nl, n)
    tops, _ = trow.sort_operands(t, desc, nl, n)
    want = np.asarray(rsort.multisort_perm(rops))
    got = tsort.multisort_perm(tops).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["i64", "u64", "f32", "f64", "s"])
def test_equality_operands_match_reference(name):
    """Rows equal under the port's equality codes are exactly the rows
    equal under the reference's (null==null, NaN==NaN, -0 == +0)."""
    rng = np.random.default_rng(3)
    arr, valid = _sort_columns(rng, 400)[name]
    rc = ct.Column.from_numpy(arr, validity=valid)
    tc = TColumn.from_numpy(arr, validity=valid, device="cpu")

    def groups(ops):
        rows = list(zip(*[np.asarray(o).tolist() for o in ops]))
        ids = {}
        return [ids.setdefault(x, len(ids)) for x in rows]

    assert groups(trow.equality_operands(tc)) == groups(rrow.equality_operands(rc))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_subnormals_stay_distinct_from_zero(dtype):
    """The reference's XLA flushes subnormals to zero, so it groups 1e-310
    with 0.0; the port keeps them apart, as pandas does."""
    x = np.array([0.0, np.finfo(dtype).smallest_subnormal, -0.0], dtype)
    code = trow.equality_operands(TColumn.from_numpy(x, device="cpu"))[0]
    assert code[0] == code[2] != code[1]
    assert tsort.multisort_perm(trow.sort_operands(
        [TColumn.from_numpy(x, device="cpu")], [False], [True], 3)[0])[:3].tolist() \
        == ([2, 0, 1] if dtype == np.float32 else [0, 2, 1])


@pytest.mark.parametrize("check_bounds", [False, True])
def test_gather_matches_reference(check_bounds):
    df, r, t = _pair("mixed")
    rng = np.random.default_rng(9)
    idx = rng.integers(-5, len(df) + 5, 1024).astype(np.int32)
    want = rcopy.gather_table(r, jnp.asarray(idx), 1000, check_bounds).to_pandas()
    got = tcopy.gather_table(t, torch.from_numpy(idx), 1000, check_bounds).to_pandas()
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("scan", ["tiled_cumsum", "tiled_cumprod", "tiled_cummax",
                                  "tiled_cummin"])
def test_prefix_scans_match_reference(scan):
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, 5000).astype(np.int64) if scan != "tiled_cumprod" else \
        rng.choice(np.array([1, -1, 1, 1], np.int64), 5000)
    want = np.asarray(getattr(rsort, scan)(jnp.asarray(x)))
    got = getattr(tsort, scan)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["nulls_and_empty", "one_letter", "all_null", "empty",
                                  "mixed_objects"])
def test_string_ingest_keeps_the_sorted_dictionary_and_codes(case):
    """Ingest factorizes, then sorts the distinct values into the dictionary:
    the dictionary, codes and nulls of np.unique over every value's str (the
    ingest it replaced), with None and NaN as nulls and "" a value."""
    rng = np.random.default_rng(len(case))
    arr = {
        "nulls_and_empty": np.array(["pear", "", None, "fig", np.nan, "", "apple", "fig"],
                                    object)[rng.integers(0, 8, 500)],
        "one_letter": rng.choice(["A", "N", "R"], 1000),
        "all_null": np.array([None, np.nan, None], object),
        "empty": np.array([], object),
        "mixed_objects": np.array(["1", 1, "b", pd.NA, np.float32("nan"), None, 2.5], object),
    }[case]
    isnull = np.array([x is None or (isinstance(x, float) and np.isnan(x)) for x in arr],
                      dtype=bool)
    vals = np.where(isnull, "", arr.astype(object))
    want_dict, want_codes = np.unique(vals.astype(str), return_inverse=True)
    col = TColumn.from_numpy(arr, device="cpu")
    np.testing.assert_array_equal(col.dictionary, want_dict)
    np.testing.assert_array_equal(col.data[: len(arr)].numpy(), want_codes.reshape(-1))
    got_null = (np.zeros(len(arr), bool) if col.validity is None
                else ~col.validity[: len(arr)].numpy())
    np.testing.assert_array_equal(got_null, isnull)


def test_table_methods_match_reference():
    """with_column, drop, rename, num_columns, __contains__ and from_pydict."""
    d = {"a": [1, 2, 3], "s": ["x", None, "y"], "f": np.array([0.5, np.nan, 2.0])}
    rt, pt = ct.Table.from_pydict(d), tt.Table.from_pydict(d, device="cpu")
    pd.testing.assert_frame_equal(pt.to_pandas(), rt.to_pandas())
    assert pt.num_columns == rt.num_columns == 3
    assert ("s" in pt, "z" in pt) == ("s" in rt, "z" in rt) == (True, False)
    for r, p in ((rt.drop(["s"]), pt.drop(["s"])),
                 (rt.rename({"a": "b"}), pt.rename({"a": "b"})),
                 (rt.with_column("a", rt["f"]), pt.with_column("a", pt["f"])),
                 (rt.with_column("g", rt["a"]), pt.with_column("g", pt["a"]))):
        assert p.names == r.names
        pd.testing.assert_frame_equal(p.to_pandas(), r.to_pandas())
    mixed = tt.Table.from_pydict({"c": pt["a"], "n": [4, 5, 6]}, device="cpu")
    assert mixed["c"] is pt["a"] and mixed.names == ["c", "n"]
