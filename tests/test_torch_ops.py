"""The port's predicate ops, distinct, key packing and copying helpers
against cudf_tpu's.

Same pandas inputs, made from a seed, go through both packages (the port
on the CPU). Tolerances: integers, booleans, keys, row orders and null
masks exact; arithmetic on floats rtol 1e-12 in f64 and 1e-6 in f32 (the
two frameworks may round a division or a promotion differently).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.core import dtypes as rdt
from cudf_tpu.ops import binaryop as rbin
from cudf_tpu.ops import copying as rcopy
from cudf_tpu.ops import stream_compaction as rsc
from cudf_tpu.ops import strings as rstr
from cudf_tpu.ops import unaryop as run

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import dtypes as tdt
from cudf_tpu_torch.core.column import Column as TColumn
from cudf_tpu_torch.ops import binaryop as tbin
from cudf_tpu_torch.ops import copying as tcopy
from cudf_tpu_torch.ops import hashgroup as thash
from cudf_tpu_torch.ops import stream_compaction as tsc
from cudf_tpu_torch.ops import strings as tstr
from cudf_tpu_torch.ops import unaryop as tun


def _frame(n=500, seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=n).astype(np.float32)
    f32[rng.random(n) < 0.05] = np.nan
    return pd.DataFrame({
        "i32": pd.arrays.IntegerArray(rng.integers(-50, 50, n).astype(np.int32),
                                      rng.random(n) < 0.1),
        "i64": rng.integers(-1000, 1000, n),
        "f32": f32,
        "f32b": rng.normal(size=n).astype(np.float32) + 3,
        "f64": rng.normal(size=n) * 100,
        "b1": pd.arrays.BooleanArray(rng.random(n) < 0.5, rng.random(n) < 0.1),
        "b2": rng.random(n) < 0.5,
        "s": np.array(["a", "b", None, "dd"], object)[rng.integers(0, 4, n)],
        "t": np.datetime64("1995-01-01", "ns")
             + rng.integers(0, 1000, n).astype("timedelta64[D]"),
    })


@pytest.fixture(scope="module")
def tables():
    df = _frame()
    return ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")


def _dt(d):
    """A dtype of either package as (kind, bits, param)."""
    return d.kind, d.bits, d.param


def assert_series_equal(got: pd.Series, want: pd.Series, rtol=0.0):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    g, w = got.to_numpy(), want.to_numpy()
    gn, wn = pd.isna(g), pd.isna(w)
    np.testing.assert_array_equal(gn, wn)
    if rtol:
        np.testing.assert_allclose(g[~gn].astype(np.float64), w[~wn].astype(np.float64),
                                   rtol=rtol)
    else:
        np.testing.assert_array_equal(g[~gn], w[~wn])


def _operand(tbl, x):
    return tbl[x[1:]] if isinstance(x, str) and x.startswith("@") else x


# "@name" is a column; anything else a scalar
OPERANDS = [("@i32", "@i64"), ("@i64", "@f32"), ("@f32", "@f64"), ("@f32", "@f32b"),
            ("@i32", 7), (7, "@i32"), ("@f32", 2.5), (2.5, "@f64"), ("@i64", None)]
ARITH = ["add", "sub", "mul", "div"]
CMP = ["eq", "ne", "lt", "le", "gt", "ge"]


@pytest.mark.parametrize("op", ARITH + CMP)
@pytest.mark.parametrize("lhs,rhs", OPERANDS)
def test_binary_op_matches_reference(tables, lhs, rhs, op):
    rt, pt = tables
    want = rbin.binary_op(_operand(rt, lhs), _operand(rt, rhs), op)
    got = tbin.binary_op(_operand(pt, lhs), _operand(pt, rhs), op)
    assert _dt(got.dtype) == _dt(want.dtype)
    rtol = 0.0
    if op in ARITH and got.dtype.is_floating:
        rtol = 1e-6 if got.dtype.bits == 32 else 1e-12
    assert_series_equal(got.to_pandas(), want.to_pandas(), rtol)


@pytest.mark.parametrize("lhs,rhs,op", [
    ("@b1", "@b2", "and"), ("@b1", "@b2", "or"), ("@b2", "@b1", "and"),
    ("@s", "b", "lt"), ("b", "@s", "le"), ("@s", "dd", "eq"), ("@s", "zz", "ne"),
    ("@t", np.datetime64("1996-03-15"), "lt"), ("@t", "@t", "sub")])
def test_binary_op_bool_string_and_time_match_reference(tables, lhs, rhs, op):
    rt, pt = tables
    want = rbin.binary_op(_operand(rt, lhs), _operand(rt, rhs), op)
    got = tbin.binary_op(_operand(pt, lhs), _operand(pt, rhs), op)
    assert _dt(got.dtype) == _dt(want.dtype)
    assert_series_equal(got.to_pandas(), want.to_pandas())


def test_binary_op_rejects_bad_operands(tables):
    _, pt = tables
    with pytest.raises(ValueError, match="lengths differ"):
        tbin.binary_op(pt["i64"], pt.slice(0, 10)["i64"], "add")
    with pytest.raises(TypeError):
        tbin.binary_op(pt["s"], "b", "add")
    with pytest.raises(ValueError, match="unknown binary op"):
        tbin.binary_op(pt["i64"], 1, "hypot")


@pytest.mark.parametrize("col,to", [
    ("i32", "int64"), ("i64", "int32"), ("i64", "float64"), ("f64", "float32"),
    ("f32", "float64"), ("b2", "int32"), ("i32", "string"), ("t", "datetime64[s]")])
def test_cast_matches_reference(tables, col, to):
    rt, pt = tables
    want = run.cast(rt[col], rdt.from_numpy(np.dtype(to)) if to != "string" else rdt.string)
    got = tun.cast(pt[col], tdt.from_name(to))
    assert _dt(got.dtype) == _dt(want.dtype)
    assert_series_equal(got.to_pandas(), want.to_pandas())


def test_cast_parses_strings_like_reference():
    df = pd.DataFrame({"s": np.array(["1", "22", None, "-3"], object)})
    want = run.cast(ct.Table.from_pandas(df)["s"], rdt.float64)
    got = tun.cast(tt.Table.from_pandas(df, device="cpu")["s"], tdt.float64)
    assert_series_equal(got.to_pandas(), want.to_pandas())


@pytest.mark.parametrize("fn", ["nans_to_nulls", "is_null", "is_valid", "is_nan"])
@pytest.mark.parametrize("col", ["f32", "i32", "f64"])
def test_null_predicates_match_reference(tables, fn, col):
    rt, pt = tables
    want = getattr(run, fn)(rt[col])
    got = getattr(tun, fn)(pt[col])
    assert _dt(got.dtype) == _dt(want.dtype)
    assert_series_equal(got.to_pandas(), want.to_pandas())


# ------------------------------------------------------------------ distinct
def _distinct_frame(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 8, n).astype(np.float64)
    f[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "g": pd.arrays.IntegerArray(rng.integers(0, 40, n), rng.random(n) < 0.05),
        "s": np.array(["a", "bb", None], object)[rng.integers(0, 3, n)],
        "f": f,
        "v": np.arange(n),
    })


KEYSETS = [["g"], ["g", "s"], ["f"], ["s", "f"]]


@pytest.mark.parametrize("pallas", ["unset", "1"])
@pytest.mark.parametrize("keep", ["first", "last"])
@pytest.mark.parametrize("keys", KEYSETS, ids="-".join)
def test_distinct_matches_reference(monkeypatch, keys, keep, pallas):
    """Both reference lanes (its sort lane, and with CUDF_TPU_PALLAS=1 its
    hash-table lane for keep="first") give the port's answer."""
    if pallas == "unset":
        monkeypatch.delenv("CUDF_TPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("CUDF_TPU_PALLAS", pallas)
    df = _distinct_frame()
    rt, pt = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    want = rsc.distinct(rt, keys, keep).to_pandas()
    got = tsc.distinct(pt, keys, keep).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    np.testing.assert_array_equal(tsc.distinct_mask(pt, keys, keep).to_numpy(),
                                  rsc.distinct_mask(rt, keys, keep).to_numpy())
    assert tsc.unique_count([pt[k] for k in keys]) == \
        rsc.unique_count([rt[k] for k in keys])
    pdw = df.drop_duplicates(keys, keep=keep)
    np.testing.assert_array_equal(got["v"].to_numpy(), pdw["v"].to_numpy())


@pytest.mark.parametrize("keys", KEYSETS, ids="-".join)
def test_distinct_keep_none_keeps_only_unique_keys(keys):
    """cuDF's KEEP_NONE and pandas keep=False drop every repeated key. The
    reference's keep="none" keeps first occurrences instead; the port does
    not copy that (ROADMAP section 3)."""
    df = _distinct_frame(400, seed=11)
    pt = tt.Table.from_pandas(df, device="cpu")
    got = tsc.distinct(pt, keys, "none").to_pandas()
    want = df.drop_duplicates(keys, keep=False)
    np.testing.assert_array_equal(got["v"].to_numpy(), want["v"].to_numpy())
    assert len(got) < len(rsc.distinct(ct.Table.from_pandas(df), keys, "none"))


# ------------------------------------------------------------- key packing
def _ops(rng, n, specs):
    return [torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int64)) for lo, hi in specs]


@pytest.mark.parametrize("specs", [
    [(0, 2), (5, 6), (-40, 40)],           # constant operand dropped
    [(0, 1 << 30), (-(1 << 20), 1 << 20)],  # two words
    [(-(1 << 62), 1 << 62)],               # one 64-bit-wide operand
    [(0, 1 << 40), (0, 1 << 23)],          # 63 bits
], ids=["small", "two_words", "wide", "63_bits"])
def test_packed_words_equal_exactly_when_operands_equal(specs):
    rng = np.random.default_rng(len(specs))
    right = _ops(rng, 3000, specs)
    left = [torch.cat([r[:1000], o[1000:]]) for r, o in zip(right, _ops(rng, 3000, specs))]
    words, bits, mins, widths = thash.pack_key_words(right, joint_with=left)
    lw = thash.pack_like(left, mins, widths)
    assert all(w.dtype == torch.int32 for w in words + lw)
    exp_bits = sum((max(r.max().item(), l.max().item()) - min(r.min().item(),
                   l.min().item())).bit_length() for r, l in zip(right, left))
    assert bits == exp_bits
    rk = {(a, b): tuple(o[i].item() for o in right) for i, (a, b) in
          enumerate(zip(words[0].tolist(), words[1].tolist()))}
    assert len(set(rk.values())) == len(rk)  # injective on the right side
    for i, (a, b) in enumerate(zip(lw[0].tolist(), lw[1].tolist())):
        key = tuple(o[i].item() for o in left)
        assert (rk.get((a, b)) == key) == (key in set(rk.values()))


def test_keys_wider_than_64_bits_do_not_pack():
    rng = np.random.default_rng(0)
    ops = _ops(rng, 500, [(0, 1 << 40), (0, 1 << 30)])
    words, bits, mins, widths = thash.pack_key_words(ops)
    assert words is None and bits > 64 and mins is None and widths is None


# ----------------------------------------------------------- copying, core
def test_concatenate_tables_matches_reference(tables):
    rt, pt = tables
    names = ["i32", "f32", "s", "b1"]
    want = rcopy.concatenate_tables([rt.select(names), rt.slice(100, 50).select(names)])
    got = tcopy.concatenate_tables([pt.select(names), pt.slice(100, 50).select(names)])
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())
    with pytest.raises(TypeError, match="one dtype"):
        tcopy.concatenate([pt["i32"], pt["i64"]])


@pytest.mark.parametrize("offset,length", [(0, 10), (490, 50), (3, None), (600, 5)])
def test_slice_matches_reference(tables, offset, length):
    rt, pt = tables
    pd.testing.assert_frame_equal(pt.slice(offset, length).to_pandas(),
                                  rt.slice(offset, length).to_pandas())


@pytest.mark.parametrize("value,dtype", [(None, "int32"), (None, "float64"), (5, None),
                                         (2.5, None), (True, None), ("x", None)])
def test_from_scalar_matches_reference(value, dtype):
    want = ct.Column.from_scalar(value, 7, rdt.from_numpy(np.dtype(dtype)) if dtype else None)
    got = TColumn.from_scalar(value, 7, tdt.from_name(dtype) if dtype else None, "cpu")
    assert _dt(got.dtype) == _dt(want.dtype) and got.capacity == want.capacity
    assert_series_equal(got.to_pandas(), want.to_pandas())


def test_unify_dictionaries_matches_reference():
    a = pd.DataFrame({"s": np.array(["b", "a", None, "c"], object)})
    b = pd.DataFrame({"s": np.array(["d", "b", "b"], object)})
    want = rstr.unify_dictionaries([ct.Table.from_pandas(a)["s"], ct.Table.from_pandas(b)["s"]])
    got = tstr.unify_dictionaries([tt.Table.from_pandas(a, device="cpu")["s"],
                                   tt.Table.from_pandas(b, device="cpu")["s"]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dictionary, w.dictionary)
        np.testing.assert_array_equal(g.data[: g.length].numpy(), np.asarray(w.data)[: w.length])
        assert_series_equal(g.to_pandas(), w.to_pandas())


NAMES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint32", "float32",
         "float64", "datetime64[ns]", "datetime64[s]", "timedelta64[ms]"]


@pytest.mark.parametrize("a", NAMES)
def test_common_dtype_matches_reference(a):
    for b in NAMES:
        want = rdt.common_dtype(rdt.from_numpy(np.dtype(a)), rdt.from_numpy(np.dtype(b)))
        got = tdt.common_dtype(tdt.from_name(a), tdt.from_name(b))
        assert _dt(got) == _dt(want), (a, b)


# ---------------------------------------------------------------------------
# the shorthand binary ops, copying's reshape helpers, known-count compaction,
# the segmented scan and the round-synchronous hash table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "eq"])
@pytest.mark.parametrize("lhs,rhs", [("@i32", "@i64"), ("@f32", "@f64"), ("@i64", 3)])
def test_shorthand_binary_ops_match_reference(tables, op, lhs, rhs):
    rt, pt = tables
    want = getattr(rbin, op)(_operand(rt, lhs), _operand(rt, rhs))
    got = getattr(tbin, op)(_operand(pt, lhs), _operand(pt, rhs))
    assert _dt(got.dtype) == _dt(want.dtype)
    rtol = 1e-6 if got.dtype.is_floating else 0.0
    assert_series_equal(got.to_pandas(), want.to_pandas(), rtol)


@pytest.mark.parametrize("cols", [["i64", "i32"], ["f32", "f32b"], ["b1", "b2"], ["s"],
                                  ["t", "t"], ["i32", "i32", "i32"]])
def test_interleave_columns_matches_reference(tables, cols):
    rt, pt = tables
    want = rcopy.interleave_columns(ct.Table({f"c{i}": rt[c] for i, c in enumerate(cols)}))
    got = tcopy.interleave_columns(tt.Table({f"c{i}": pt[c] for i, c in enumerate(cols)}))
    assert got.length == want.length == len(cols) * rt.num_rows
    assert _dt(got.dtype) == _dt(want.dtype)
    assert_series_equal(got.to_pandas(), want.to_pandas())


def test_interleave_from_pydict():
    want = rcopy.interleave_columns(ct.Table.from_pydict({"a": [1, 2], "b": [10, 20]}))
    got = tcopy.interleave_columns(tt.Table.from_pydict({"a": [1, 2], "b": [10, 20]},
                                                        device="cpu"))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(got.to_numpy(), [1, 10, 2, 20])


@pytest.mark.parametrize("col", ["b1", "b2", "i32", "f32"])
def test_bools_to_mask_matches_reference(tables, col):
    rt, pt = tables
    want, got = rcopy.bools_to_mask(rt[col]), tcopy.bools_to_mask(pt[col])
    assert got.null_count == want.null_count
    assert_series_equal(got.to_pandas(), want.to_pandas())


@pytest.mark.parametrize("cols", [["i32", "i64"], ["f32", "b2"], ["s", "t", "b1"],
                                  list(_frame().columns)])
def test_row_bit_count_matches_reference(tables, cols):
    rt, pt = tables
    want = rcopy.row_bit_count(rt.select(cols))
    got = tcopy.row_bit_count(pt.select(cols))
    assert _dt(got.dtype) == _dt(want.dtype)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("mask_col", ["b1", "b2"])
def test_compact_known_count_matches_reference(tables, mask_col):
    rt, pt = tables
    n_out = int((rt[mask_col].to_pandas().fillna(False)).sum())
    want = rsc.compact_known_count(rt, rt[mask_col], n_out)
    got = tsc.compact_known_count(pt, pt[mask_col], n_out)
    assert got.num_rows == want.num_rows == n_out
    for name in rt.names:
        assert_series_equal(got[name].to_pandas(), want[name].to_pandas())
    for name in rt.names:
        assert_series_equal(got[name].to_pandas(),
                            tsc.apply_boolean_mask(pt, pt[mask_col])[name].to_pandas())


def _combines():
    import jax.numpy as jnp

    return {
        "add": (jnp.add, torch.add), "min": (jnp.minimum, torch.minimum),
        "max": (jnp.maximum, torch.maximum), "mul": (jnp.multiply, torch.mul),
        "keep_first": (lambda a, b: a, lambda a, b: a),
    }


@pytest.mark.parametrize("name", ["add", "min", "max", "mul", "keep_first"])
@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_segmented_scan_matches_reference(name, n):
    import jax.numpy as jnp
    from cudf_tpu.ops import sortprim as rsp
    from cudf_tpu_torch.ops import sortprim as tsp

    rng = np.random.default_rng(n)
    rc, tc = _combines()[name]
    newseg = rng.random(n) < 0.2
    for vals in (rng.integers(-3, 4, n), rng.integers(-3, 4, n).astype(np.float64)):
        want = np.asarray(rsp.segmented_scan(jnp.asarray(vals), jnp.asarray(newseg), rc))
        got = tsp.segmented_scan(torch.from_numpy(vals), torch.from_numpy(newseg), tc)
        np.testing.assert_array_equal(got.numpy(), want)


def test_segmented_scan_of_floats_within_rounding():
    import jax.numpy as jnp
    from cudf_tpu.ops import sortprim as rsp
    from cudf_tpu_torch.ops import sortprim as tsp

    rng = np.random.default_rng(0)
    vals, newseg = rng.normal(size=5000), rng.random(5000) < 0.01
    want = np.asarray(rsp.segmented_scan(jnp.asarray(vals), jnp.asarray(newseg), jnp.add))
    got = tsp.segmented_scan(torch.from_numpy(vals), torch.from_numpy(newseg), torch.add)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


def _hash_words(rng, n, nkeys, spread):
    """The reference's packed words of ``nkeys`` int64 keys drawn from a pool
    of ``spread`` values a key, as numpy uint32 arrays, and their width."""
    from cudf_tpu.ops import hashgroup as rhash

    df = pd.DataFrame({f"k{i}": rng.integers(0, 2**40, spread)[rng.integers(0, spread, n)]
                       for i in range(nkeys)})
    t = ct.Table.from_pandas(df)
    words, width, _, _ = rhash.pack_key_words(rhash.equality_ops([t[c] for c in df]))
    return [np.asarray(w) for w in words], width


@pytest.mark.parametrize("nkeys,spread", [(1, 300), (2, 50), (3, 2000)])
def test_hash_builds_and_lookup_are_bit_equal(nkeys, spread):
    import jax.numpy as jnp
    from cudf_tpu.ops import hashgroup as rhash

    rng = np.random.default_rng(nkeys)
    n = 3000
    words, width = _hash_words(rng, n, nkeys, spread)
    n = len(words[0])  # the padded capacity
    active = (rng.random(n) < 0.9) & (np.arange(n) < 3000)
    tbits, direct = rhash.table_bits(n, width)
    assert thash.table_bits(n, width) == (tbits, direct) and not direct
    assert thash.DIRECT_BITS == rhash.DIRECT_BITS == 23
    rw = tuple(jnp.asarray(w) for w in words)
    tw = [torch.from_numpy(w.astype(np.int64)) for w in words]
    rslot, rrep = rhash.build_probe(rw, jnp.asarray(active), tbits)
    tslot, trep = thash.build_probe(tw, torch.from_numpy(active), tbits)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(rrep))
    # probe rows: the build's rows shuffled, half of them with one word changed
    perm = rng.permutation(n)
    pw = [w[perm].copy() for w in words]
    pw[-1][: n // 2] ^= 0x5A5A5A5A
    pact = rng.random(n) < 0.95
    want = rhash.lookup(tuple(jnp.asarray(w) for w in pw), jnp.asarray(pact), rrep, rw,
                        tbits, False)
    got = thash.lookup([torch.from_numpy(w).to(torch.int32) for w in pw],
                       torch.from_numpy(pact), trep, tw, tbits, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < (1 << tbits)).sum() > n // 4


@pytest.mark.parametrize("width", [1, 9, 23])
def test_direct_build_and_lookup_are_bit_equal(width):
    import jax.numpy as jnp
    from cudf_tpu.ops import hashgroup as rhash

    rng = np.random.default_rng(width)
    n = 4000
    w = rng.integers(0, 1 << width, n).astype(np.uint32)
    active = rng.random(n) < 0.8
    tbits, direct = rhash.table_bits(n, width)
    assert thash.table_bits(n, width) == (tbits, direct) and direct
    rslot, rrep = rhash.build_direct((jnp.asarray(w),), jnp.asarray(active), tbits)
    tslot, trep = thash.build_direct([torch.from_numpy(w.astype(np.int64))],
                                     torch.from_numpy(active), tbits)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(rrep))
    q = rng.integers(0, 1 << width, n).astype(np.uint32)
    qact = rng.random(n) < 0.9
    want = rhash.lookup((jnp.asarray(q),), jnp.asarray(qact), rrep, (jnp.asarray(w),),
                        tbits, True)
    got = thash.lookup([torch.from_numpy(q.astype(np.int64))], torch.from_numpy(qact),
                       trep, [torch.from_numpy(w.astype(np.int64))], tbits, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
