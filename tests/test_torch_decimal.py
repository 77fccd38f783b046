"""The port's decimals (``ops/decimal.py``, ``ops/decimal128.py``) against
cudf_tpu's.

The same seeded numpy inputs go through both packages (the port on the
CPU); every result must be exactly equal: dtype and scale, the unscaled
data of every row (under nulls too), the null mask. The decimal128 limbs
are compared as the exact Python ints they hold and held against Python's
``decimal`` as well. The cases of ``tests/test_decimal_pack_bloom.py`` and
``tests/test_dtypes_round3.py`` are parameters here.
"""
import decimal as pydec

import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.ops import decimal as RD
from cudf_tpu.ops import decimal128 as R128
from cudf_tpu.ops import join as rjoin
from cudf_tpu.ops import pack as rpack
from cudf_tpu.ops import sorting as rsorting
from cudf_tpu.ops.sortprim import multisort_perm as r_multisort_perm

import cudf_tpu_torch as tt
from cudf_tpu_torch.kernels import hashtable as tht
from cudf_tpu_torch.kernels import onehot_groupby as tonehot
from cudf_tpu_torch.ops import decimal as TD
from cudf_tpu_torch.ops import decimal128 as T128
from cudf_tpu_torch.ops import groupby as tgroupby
from cudf_tpu_torch.ops import join as tjoin
from cudf_tpu_torch.ops import pack as tpack
from cudf_tpu_torch.ops import sorting as tsorting
from cudf_tpu_torch.ops.sortprim import multisort_perm as t_multisort_perm

@pytest.fixture(scope="module", autouse=True)
def _drop_the_reference_traces():
    """A jitted op of the reference returns the dictionary of its first
    trace (pinned in test_torch_lists.py): the traces made here are dropped
    when the module ends, so no later module decodes with its dictionaries."""
    yield
    jax.clear_caches()


I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)


def _cols(vals, validity=None):
    vals = np.asarray(vals)
    return (ct.Column.from_numpy(vals, validity),
            tt.Column.from_numpy(vals, validity, device="cpu"))


def _dec_pair(ints, scale, bits=64, validity=None):
    r, t = _cols(np.asarray(ints, np.int64), validity)
    return RD.from_integers(r, scale, bits), TD.from_integers(t, scale, bits)


def _same(r, t):
    """Equal dtype, unscaled data of every row and null mask."""
    assert (r.dtype.kind, r.dtype.bits, r.dtype.param) == \
        (t.dtype.kind, t.dtype.bits, t.dtype.param)
    n = r.length
    assert t.length == n
    np.testing.assert_array_equal(np.asarray(r.data)[:n], t.data[:n].numpy())
    rv = np.ones(n, bool) if r.validity is None else np.asarray(r.validity)[:n]
    tv = np.ones(n, bool) if t.validity is None else t.validity[:n].numpy()
    np.testing.assert_array_equal(rv, tv)


def _operands(seed, n=300):
    """Seeded unscaled ints: wide values, small ones, zeros in both sides,
    signs mixed, and values whose products and rescales wrap int64."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-10 ** 12, 10 ** 12, n)
    b = rng.integers(-1000, 1000, n)
    b[::7] = 0
    a[::11] = 0
    a[:6] = [I64_MAX, I64_MIN + 1, 7, -7, 10 ** 17, -(10 ** 17)]
    b[:6] = [3, -2, 2, -2, -(10 ** 3), 10 ** 3]
    valid = rng.random(n) > 0.1
    return a.astype(np.int64), b.astype(np.int64), valid


BINOPS = ["add", "sub", "mod", "mul", "div", "eq", "ne", "lt", "le", "gt", "ge"]
SCALES = [(-2, -2), (-2, -4), (-4, -1), (0, -3), (2, -1)]


@pytest.mark.parametrize("op", BINOPS)
@pytest.mark.parametrize("sl,sr", SCALES)
def test_binary_op_equals_reference(op, sl, sr):
    a, b, valid = _operands(abs(sl * 7 + sr))
    ra, ta = _dec_pair(a, sl, validity=valid)
    rb, tb = _dec_pair(b, sr)
    _same(RD.binary_op(ra, rb, op), TD.binary_op(ta, tb, op))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mod"])
def test_decimal32_promotes_and_equals_reference(op):
    a, b, valid = _operands(3)
    a = np.clip(a, -(10 ** 8), 10 ** 8)
    ra, ta = _dec_pair(a, -2, bits=32, validity=valid)
    rb, tb = _dec_pair(b, -2, bits=32)
    assert ta.dtype.bits == 32 and ta.data.dtype == torch.int32
    _same(RD.binary_op(ra, rb, op), TD.binary_op(ta, tb, op))


@pytest.mark.parametrize("rhs", [3, -4, 0, 2.5, -0.125])
@pytest.mark.parametrize("op", ["add", "mul", "div", "lt"])
def test_python_scalar_right_operand(op, rhs):
    a, _, valid = _operands(5)
    ra, ta = _dec_pair(a, -3, validity=valid)
    _same(RD.binary_op(ra, rhs, op), TD.binary_op(ta, rhs, op))


def test_division_truncates_and_zero_gives_null():
    ra, ta = _dec_pair([7, -7, 7, -7, 5, -9], 0)
    rb, tb = _dec_pair([2, 2, -2, -2, 0, 0], 0)
    for op in ("div", "mod"):
        r, t = RD.binary_op(ra, rb, op), TD.binary_op(ta, tb, op)
        _same(r, t)
        assert t.data[4:6].tolist() == [0, 0]
        assert t.validity[:6].tolist() == [True] * 4 + [False] * 2
    assert TD.binary_op(ta, tb, "div").data[:4].tolist() == [3, -3, -3, 3]
    # mod follows the divisor's sign, as the reference's floor mod does
    assert TD.binary_op(ta, tb, "mod").data[:4].tolist() == [1, 1, -1, -1]


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("scale", [-4, -2, 0, 1])
def test_from_floats_to_floats(scale, bits):
    rng = np.random.default_rng(scale + 10)
    x = np.round(rng.normal(0, 1000, 200), 3)
    x[:8] = [0.5, -0.5, 1.25, -1.25, 2.675, np.nan, 1e30, -1e30]
    r, t = _cols(x)
    rd, td = RD.from_floats(r, scale, bits), TD.from_floats(t, scale, bits)
    _same(rd, td)
    _same(RD.to_floats(rd), TD.to_floats(td))
    r32, t32 = _cols(x.astype(np.float32))
    _same(RD.from_floats(r32, scale, bits), TD.from_floats(t32, scale, bits))


@pytest.mark.parametrize("to_scale", [-6, -3, -2, 0, 2])
def test_rescale_rounds_half_away_and_wraps(to_scale):
    ints = [12345, -12345, 12350, -12350, 5, -5, 0, I64_MAX // 10, I64_MIN // 10]
    r, t = _dec_pair(ints, -3)
    _same(RD.rescale(r, to_scale), TD.rescale(t, to_scale))
    if to_scale == -6:  # 10^3 times a value near int64's end wraps
        assert TD.rescale(t, -6).data[7].item() == \
            ((I64_MAX // 10) * 1000 + (1 << 63)) % (1 << 64) - (1 << 63)


@pytest.mark.parametrize("how", ["half_up", "half_even"])
@pytest.mark.parametrize("places", [-1, 0, 1, 2, 4])
def test_round_decimal(places, how):
    ints = [125, -125, 135, -135, 150, -150, 249, 0, 999999, -999999]
    r, t = _dec_pair(ints, -2)
    _same(RD.round_decimal(r, places, how), TD.round_decimal(t, places, how))


@pytest.mark.parametrize("scale", [-3, 0, 2])
def test_to_strings_against_python_decimal(scale):
    ints = [0, 1, -1, 1234567, -1234567, 5, I64_MAX, I64_MIN, 42]
    valid = np.array([True] * 8 + [False])
    r, t = _dec_pair(ints, scale, validity=valid)
    rs, ts = RD.to_strings(r), TD.to_strings(t)
    assert list(rs.to_numpy()) == list(ts.to_numpy())
    want = [str(pydec.Decimal(i).scaleb(scale)) if scale < 0 else str(i * 10 ** scale)
            for i in ints[:8]]
    assert list(ts.to_numpy()) == want + [None]


# the reference's own cases (tests/test_decimal_pack_bloom.py:11-60,120)
REF_CASES = {
    "add_rescale": ([1.23, -4.50, 0.07], -2, [0.1, 0.3, 1.0], -1, "add"),
    "mul": ([1.5, 2.5], -1, [0.2, 0.4], -1, "mul"),
    "div": ([1.5, 2.5], -1, [0.2, 0.4], -1, "div"),
    "compare": ([1.00, 2.00], -2, [1.0, 0.0], -1, "eq"),
    "div_by_zero": ([1.00, 2.00], -2, [1.0, 0.0], -1, "div"),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_reference_cases(case):
    x, sx, y, sy, op = REF_CASES[case]
    rx, tx = _cols(np.array(x))
    ry, ty = _cols(np.array(y))
    r = RD.binary_op(RD.from_floats(rx, sx), RD.from_floats(ry, sy), op)
    t = TD.binary_op(TD.from_floats(tx, sx), TD.from_floats(ty, sy), op)
    _same(r, t)
    assert r.null_count == t.null_count


def test_rescale_roundtrip_and_decimal32_arith():
    r, t = _dec_pair([12345, -999], -2)
    _same(RD.rescale(RD.rescale(r, -4), -2), TD.rescale(TD.rescale(t, -4), -2))
    rx, tx = _cols(np.array([1.25, -2.5, 3.33]))
    ry, ty = _cols(np.array([0.75, 1.0, 0.67]))
    ra, ta = RD.from_floats(rx, -2, bits=32), TD.from_floats(tx, -2, bits=32)
    rb, tb = RD.from_floats(ry, -2, bits=32), TD.from_floats(ty, -2, bits=32)
    for op in ("add", "mul"):
        _same(RD.binary_op(ra, rb, op), TD.binary_op(ta, tb, op))
    np.testing.assert_allclose(TD.to_floats(TD.binary_op(ta, tb, "add")).to_numpy(),
                               [2.0, -1.5, 4.0])


# ------------------------------------------------------------------ ingest
def test_decimal_objects_and_arrow_decimals_ingest_as_the_reference():
    D = pydec.Decimal
    objs = np.array([D("1.25"), None, D("-3.5"), D("NaN"), D("1.25")], object)
    r, t = ct.Column.from_numpy(objs), tt.Column.from_numpy(objs, device="cpu")
    assert list(r.dictionary) == list(t.dictionary)
    _same(r, t)
    for arr in (pa.array([D("1.25"), None, D("-3.50")], pa.decimal128(10, 2)),
                pa.array([D("1.25"), D("-3.50")], pa.decimal128(10, 2)),
                pa.array([D("12345678901234567890.5")], pa.decimal256(40, 1))):
        r, t = ct.Column.from_arrow(arr), tt.Column.from_arrow(arr, device="cpu")
        assert list(r.dictionary) == list(t.dictionary)
        _same(r, t)
    df = pd.DataFrame({"d": objs})
    r, t = ct.Table.from_pandas(df)["d"], tt.Table.from_pandas(df, device="cpu")["d"]
    assert list(r.dictionary) == list(t.dictionary)
    _same(r, t)


# ----------------------------------------------------- keys, sort, join, pack
def _key_tables(key_dtype, seed=0, n=500):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 11, n).astype(np.int64)
    v = rng.normal(size=n).astype(np.float32)
    valid = rng.random(n) > 0.05
    rk, tk = _cols(k, valid)
    rv, tv = _cols(v)
    if key_dtype == "decimal64":
        rk, tk = RD.from_integers(rk, -2), TD.from_integers(tk, -2)
    return ct.Table({"k": rk, "v": rv}), tt.Table({"k": tk, "v": tv})


@pytest.mark.parametrize("key_dtype", ["int64", "decimal64"])
def test_groupby_decimal_key_takes_the_int64_lanes(monkeypatch, key_dtype):
    from cudf_tpu.ops.groupby import AggSpec as RSpec, groupby_aggregate as r_groupby

    calls = []
    inner = tonehot.groupby_sum_count_plain
    monkeypatch.setattr(tonehot, "groupby_sum_count_plain",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    rt, tt_ = _key_tables(key_dtype)
    aggs = [("v", "sum", "s"), ("", "size", "n")]
    r = r_groupby(rt, ["k"], [RSpec(*a) for a in aggs])
    t = tgroupby.groupby_aggregate(tt_, ["k"], [tgroupby.AggSpec(*a) for a in aggs])
    assert calls == [1]  # the one-hot lane, as for an int64 key
    _same(r["k"], t["k"])
    _same(r["n"], t["n"])
    np.testing.assert_allclose(t["s"].to_numpy(), r["s"].to_numpy(), rtol=2e-4)


@pytest.mark.parametrize("span", [10, 1 << 40, 1 << 62])
def test_decimal64_key_stats_equal_int64s(span):
    """Stats pick every groupby and join lane: a decimal64 key's equal an
    int64 key's on the same data, past 2^53 too."""
    from cudf_tpu_torch.core import stats as tstats

    rng = np.random.default_rng(span % 97)
    vals = rng.integers(-span, span, 200).astype(np.int64)
    _, t = _cols(vals, rng.random(200) > 0.1)
    assert tstats.compute_stats(TD.from_integers(t, -2)) == tstats.compute_stats(
        tt.Column(t.dtype, t.data, t.validity, t.length))


@pytest.mark.parametrize("key_dtype", ["int64", "decimal64"])
@pytest.mark.parametrize("how", ["inner", "left", "semi"])
def test_join_on_decimal_keys_takes_the_hash_lane(monkeypatch, key_dtype, how):
    calls = []
    inner = tht.probe_table
    monkeypatch.setattr(tht, "probe_table", lambda *a, **k: calls.append(1) or inner(*a, **k))
    rl, tl = _key_tables(key_dtype, seed=1, n=300)
    rng = np.random.default_rng(2)
    keys = rng.permutation(15)[:9].astype(np.int64)
    rr, tr = _cols(keys)
    rw, tw = _cols(np.arange(9, dtype=np.int64))
    if key_dtype == "decimal64":
        rr, tr = RD.from_integers(rr, -2), TD.from_integers(tr, -2)
    r = rjoin.join(rl, ct.Table({"k": rr, "w": rw}), ["k"], ["k"], how)
    t = tjoin.join(tl, tt.Table({"k": tr, "w": tw}), ["k"], ["k"], how)
    assert calls, "the hash-table lane"
    assert r.names == t.names
    for name in r.names:
        _same(r[name], t[name])


@pytest.mark.parametrize("descending", [False, True])
def test_sort_by_decimal_key(descending):
    a, _, valid = _operands(9)
    ra, ta = _dec_pair(a, -2, validity=valid)
    rb, tb = _dec_pair(np.arange(len(a)), 0)
    r = rsorting.sort_by_key(ct.Table({"d": ra, "i": rb}), ["d"], descending=descending)
    t = tsorting.sort_by_key(tt.Table({"d": ta, "i": tb}), ["d"], descending=descending)
    # the valid rows equal the reference's; its null rows follow the payload
    # under them, a fault pinned in test_torch_sorting.py, so the whole order
    # is held against a stable numpy sort (nulls last, in row order)
    nv = int(valid.sum())
    np.testing.assert_array_equal(t["i"].data[:nv].numpy(), np.asarray(r["i"].data)[:nv])
    key = np.where(valid, -a if descending else a, 0)
    want = np.lexsort((np.arange(len(a)), key, ~valid))
    np.testing.assert_array_equal(t["i"].data[:len(a)].numpy(), want)
    np.testing.assert_array_equal(t["d"].data[:nv].numpy(), a[want[:nv]])


@pytest.mark.parametrize("bits", [32, 64])
def test_pack_round_trip(bits):
    a, _, valid = _operands(4, n=57)
    a = np.clip(a, -(10 ** 8), 10 ** 8)
    ra, ta = _dec_pair(a, -3, bits=bits, validity=valid)
    rblob = rpack.pack(ct.Table({"d": ra}))
    tblob = tpack.pack(tt.Table({"d": ta}))
    assert rblob.metadata == tblob.metadata and rblob.buffer == tblob.buffer
    _same(rpack.unpack(rblob)["d"], tpack.unpack(tblob, device="cpu")["d"])


# ---------------------------------------------------------------- decimal128
def _d128(ints, scale, validity=None):
    return (R128.Decimal128Column.from_ints(ints, scale, validity),
            T128.Decimal128Column.from_ints(ints, scale, validity, device="cpu"))


def _same128(r, t):
    assert r.scale == t.scale and r.length == t.length
    assert r.to_python() == t.to_python()


# values across the limb boundaries: 2^63 and 2^64 in the low limb, the
# high limb's sign, the 128-bit ends
EDGES = [0, 1, -1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 1 << 64, -(1 << 63),
         -(1 << 64), -(1 << 64) - 1, (1 << 127) - 1, -(1 << 127), 10 ** 30, -(10 ** 37),
         2 ** 100, -(2 ** 120)]


def _wrap128(x):
    x &= (1 << 128) - 1
    return x - (1 << 128) if x >> 127 else x


def test_from_ints_round_trip_and_decimals():
    r, t = _d128(EDGES + [None], -4)
    _same128(r, t)
    assert t.to_python() == EDGES + [None]
    assert t.to_decimals()[12] == pydec.Decimal(10 ** 30).scaleb(-4)
    assert t.to_decimals() == r.to_decimals()
    assert list(t.to_strings().to_numpy()) == list(r.to_strings().to_numpy())
    np.testing.assert_array_equal(t.to_floats().to_numpy(), r.to_floats().to_numpy())


@pytest.mark.parametrize("op,sl,sr", [("add", -2, -4), ("sub", -4, -2), ("mul", -2, -3),
                                      ("add", 0, 0), ("sub", 0, 0), ("mul", 0, 0)])
def test_decimal128_arith_scale_rules(op, sl, sr):
    rng = np.random.default_rng(6)
    a = [int(x) for x in rng.integers(-10 ** 12, 10 ** 12, 50)] + [10 ** 18, -(10 ** 17), 0]
    b = [int(x) for x in rng.integers(-10 ** 12, 10 ** 12, 50)] + [-(10 ** 18), 10 ** 17, 5]
    if sl == sr == 0:  # the carries: every pair of boundary values
        a = [x for x in EDGES for _ in EDGES]
        b = [y for _ in EDGES for y in EDGES]
    ra, ta = _d128(a, sl)
    rb, tb = _d128(b, sr)
    r, t = R128.binary_op(ra, rb, op), T128.binary_op(ta, tb, op)
    _same128(r, t)
    s = {"add": min(sl, sr), "sub": min(sl, sr), "mul": sl + sr}[op]
    assert t.scale == s
    for x, y, g in zip(a, b, t.to_python()):
        x, y = x * 10 ** (sl - min(sl, sr)), y * 10 ** (sr - min(sl, sr))
        e = {"add": x + y, "sub": x - y}.get(op)
        if op == "mul":
            e = (x // 10 ** (sl - min(sl, sr))) * (y // 10 ** (sr - min(sl, sr)))
        assert g == _wrap128(e)


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
def test_decimal128_compare(op):
    ra, ta = _d128([10 ** 20, -5, 0, 123] + EDGES, -2)
    rb, tb = _d128([10 ** 18, -6, 0, 1] + EDGES[::-1], 0)
    r, t = R128.binary_op(ra, rb, op), T128.binary_op(ta, tb, op)
    _same(r, t)


def test_decimal128_int_operand_and_validity():
    ra, ta = _d128([5, None, -7, 1 << 64], -1, validity=[True, True, False, True])
    for op in ("add", "mul", "lt"):
        r, t = R128.binary_op(ra, 3, op), T128.binary_op(ta, 3, op)
        if op == "lt":
            _same(r, t)
        else:
            _same128(r, t)


def test_decimal128_div_on_the_host_against_python_decimal():
    a = [10 ** 25, -(10 ** 25), 7, -7, 5, 1 << 100, None]
    b = [3, 3, 2, 2, 0, -(1 << 64) - 3, 1]
    ra, ta = _d128(a, -3)
    rb, tb = _d128(b, 0)
    r, t = R128.binary_op(ra, rb, "div"), T128.binary_op(ta, tb, "div")
    _same128(r, t)
    assert t.scale == -3
    with pydec.localcontext() as ctx:
        ctx.prec = 80
        for x, y, g in zip(a, b, t.to_python()):
            if x is None or y == 0:
                assert g is None
            else:
                q = (pydec.Decimal(x) / pydec.Decimal(y)).to_integral_value(pydec.ROUND_DOWN)
                assert g == int(q)


@pytest.mark.parametrize("vals,frm,to", [
    ([12345, -12345, 12350, -12350], -4, -2),       # half away from zero
    ([123, -123, 124, -124], -2, -4),
    ([10 ** 30 + 55555, -(10 ** 30 + 55555)], -20, 0),  # divides in 10^9 chunks
    (EDGES, 0, -3),                                     # wraps
    (EDGES, -5, 13),
])
def test_decimal128_rescale(vals, frm, to):
    r, t = _d128(vals, frm)
    _same128(R128.rescale(r, to), T128.rescale(t, to))


def test_decimal128_from_decimal64():
    r64, t64 = _dec_pair([123, -456, I64_MIN, I64_MAX], -2, validity=[True, False, True, True])
    r, t = R128.Decimal128Column.from_decimal64(r64), T128.Decimal128Column.from_decimal64(t64)
    _same128(r, t)
    assert t.to_python() == [123, None, I64_MIN, I64_MAX] and t.scale == -2


def test_order_operands_sort_as_the_reference():
    rng = np.random.default_rng(8)
    vals = EDGES + [int(x) for x in rng.integers(-(10 ** 12), 10 ** 12, 40)] + EDGES[:5]
    r, t = _d128(vals, 0)
    rperm = [i for i in np.asarray(r_multisort_perm(R128.order_operands(r))) if i < len(vals)]
    tperm = [i for i in t_multisort_perm(T128.order_operands(t)).tolist() if i < len(vals)]
    assert tperm == rperm
    assert [vals[i] for i in tperm] == sorted(vals)


def test_reference_int64_sort_over_the_full_range_overflows():
    """Pinned: the reference's sort of an int64 key whose values span more
    than 2^63 raises OverflowError (its key range leaves int64); the port
    sorts it, and its decimal64 twin the same way."""
    vals = np.array([I64_MAX, I64_MIN + 1, 0, -5], np.int64)
    r, t = _cols(vals)
    with pytest.raises(OverflowError):
        rsorting.sort_by_key(ct.Table({"k": r}), ["k"])
    assert tsorting.sort_by_key(tt.Table({"k": t}), ["k"])["k"].to_numpy().tolist() == \
        sorted(vals.tolist())
    d = tsorting.sort_by_key(tt.Table({"k": TD.from_integers(t, -2)}), ["k"])["k"]
    assert d.data[:4].tolist() == sorted(vals.tolist())
