"""The dense-slot groupby lane (``ops/densegroup.py``) and its kernel
(``kernels/dense_groupby.py``).

On the CPU the lane runs the kernel's plain version, which folds each
slot's rows in row order, as the sort lane's per-group sums do there: so
every case holds the dense lane's answer, bit for bit (the data under the
nulls included), against the sort lane's on the same table, with the dense
lane switched off by ``monkeypatch``. The cases the lane must refuse reach
the sort lane. On the card (``cuda``): the kernel against its plain
version, integers and counts in equal bits, float sums within the bound of
any order of their terms, and the same bits on a second launch.
"""
import math

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import dtypes as tdt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.kernels import dense_groupby as K
from cudf_tpu_torch.ops import densegroup, sortgroup
from cudf_tpu_torch.ops import groupby as tgb
from cudf_tpu_torch.ops import stream_compaction as tsc


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def _raw(tbl):
    """{column: (dtype, data bits, validity or None)} of a Table's rows."""
    n = tbl.num_rows
    return {name: (c.dtype, _bits(c.data[:n]),
                   None if c.validity is None else c.validity[:n]) for name, c in tbl}


class _Lanes:
    """Which lanes answered: the dense lane's answers, the sort lane's."""

    def __init__(self, monkeypatch):
        self.dense, self.sort = [], []
        for mod, name, log in ((densegroup, "dense_groupby", self.dense),
                               (sortgroup, "sort_groupby", self.sort)):
            inner = getattr(mod, name)

            def spy(*a, _inner=inner, _log=log, **k):
                out = _inner(*a, **k)
                _log.append(out is not None)
                return out

            monkeypatch.setattr(mod, name, spy)


def _dense_and_sort(monkeypatch, tbl, keys, aggs, dropna):
    """groupby_aggregate's answer by the dense lane, then by the sort lane
    with the dense lane switched off."""
    lanes = _Lanes(monkeypatch)
    got = tgb.groupby_aggregate(tbl, keys, aggs, dropna)
    assert lanes.dense == [True] and lanes.sort == []
    monkeypatch.setattr(densegroup, "dense_groupby", lambda *a, **k: None)
    want = tgb.groupby_aggregate(tbl, keys, aggs, dropna)
    assert lanes.sort == [True]
    return got, want


def _assert_bits_equal(got, want):
    g, w = _raw(got), _raw(want)
    assert list(g) == list(w)
    for name in w:
        assert g[name][0] == w[name][0], name
        assert torch.equal(g[name][1], w[name][1]), name
        assert (g[name][2] is None) == (w[name][2] is None), name
        if w[name][2] is not None:
            assert torch.equal(g[name][2], w[name][2]), name
    for (_, gc), (_, wc) in zip(got, want):
        assert gc.capacity == wc.capacity


def _nulls(rng, a, p):
    """A pandas nullable array of ``a`` with a share ``p`` of nulls."""
    mask = rng.random(len(a)) < p
    if a.dtype.kind == "f":
        return pd.arrays.FloatingArray(a, mask)
    return pd.arrays.IntegerArray(a, mask)


def _specs(*triples):
    return [tgb.AggSpec(*t) for t in triples]


SUMS = ("sum", "mean", "count")


def _all_kinds(*cols):
    return _specs(*[(c, kind, f"{c}_{kind}") for c in cols for kind in SUMS],
                  ("", "size", "n"))


def _case(name, n=3000):
    """(table, keys, aggregations) of a seeded case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    f64 = rng.normal(size=n) * 10.0 ** rng.integers(-3, 6, n)
    if name == "int8_key":
        df = pd.DataFrame({"k": _nulls(rng, rng.integers(-3, 9, n).astype(np.int8), 0.1),
                           "x": _nulls(rng, np.where(rng.random(n) < 0.05, np.nan, f64), 0.1)})
        return df, ["k"], _all_kinds("x")
    if name == "int32_key_int_values":
        df = pd.DataFrame({"k": rng.integers(1, 101, n).astype(np.int32),
                           "i": rng.integers(1, 6, n).astype(np.int32),
                           "j": _nulls(rng, rng.integers(-2**40, 2**40, n), 0.2)})
        return df, ["k"], _all_kinds("i", "j")
    if name == "string_key":
        df = pd.DataFrame({"s": np.array(["id001", "id002", None, "id100"],
                                         object)[rng.integers(0, 4, n)],
                           "x": f64, "y": rng.normal(size=n).astype(np.float32)})
        return df, ["s"], _all_kinds("x", "y")
    if name == "two_keys":
        df = pd.DataFrame({"a": _nulls(rng, rng.integers(0, 5, n).astype(np.int8), 0.05),
                           "s": np.array(["p", "q", None], object)[rng.integers(0, 3, n)],
                           "x": _nulls(rng, f64, 0.1), "i": rng.integers(-9, 9, n)})
        return df, ["a", "s"], _all_kinds("x", "i")
    if name == "three_keys":
        df = pd.DataFrame({"b": rng.random(n) < 0.5,
                           "u": rng.integers(3, 9, n).astype(np.uint16),
                           "f": np.where(rng.random(n) < 0.1, np.nan,
                                         rng.integers(-4, 4, n).astype(np.float64)),
                           "x": f64, "i": rng.integers(0, 100, n).astype(np.int16)})
        return df, ["b", "u", "f"], _all_kinds("x", "i")
    if name == "int64_sum_wraps":
        df = pd.DataFrame({"k": rng.integers(0, 3, n),
                           "big": rng.integers(2**61, 2**63 - 1, n),
                           "x": f64})
        return df, ["k"], _all_kinds("big", "x")
    if name == "uint_bool_values":
        df = pd.DataFrame({"k": rng.integers(0, 7, n).astype(np.uint8),
                           "u8": rng.integers(0, 256, n).astype(np.uint8),
                           "u64": rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64),
                           "flag": rng.random(n) < 0.3})
        return df, ["k"], _all_kinds("u8", "u64", "flag")
    if name == "one_group":
        df = pd.DataFrame({"k": np.full(n, 7, np.int32), "x": _nulls(rng, f64, 0.3),
                           "i": rng.integers(-5, 5, n).astype(np.int32)})
        return df, ["k"], _all_kinds("x", "i")
    if name == "2048_slots":
        n = 3 * 2048
        df = pd.DataFrame({"k": np.r_[np.arange(2048), rng.integers(0, 2048, n - 2048)],
                           "x": rng.normal(size=n), "i": rng.integers(0, 9, n).astype(np.int32)})
        return df, ["k"], _specs(("x", "sum", "xs"), ("i", "sum", "is"), ("", "size", "n"))
    if name == "nan_value_stays_in_its_group":
        x = np.arange(n, dtype=np.float64)
        k = rng.integers(0, 4, n)
        x[np.nonzero(k == 2)[0][3]] = np.nan
        df = pd.DataFrame({"k": k, "x": x, "y": -x})
        return df, ["k"], _all_kinds("x", "y")
    raise KeyError(name)


LANE_CASES = ["int8_key", "int32_key_int_values", "string_key", "two_keys", "three_keys",
              "int64_sum_wraps", "uint_bool_values", "one_group", "2048_slots",
              "nan_value_stays_in_its_group"]


@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("case", LANE_CASES)
def test_dense_lane_equals_the_sort_lane_bit_for_bit(monkeypatch, case, dropna):
    df, keys, aggs = _case(case)
    tbl = tt.Table.from_pandas(df, device="cpu")
    got, want = _dense_and_sort(monkeypatch, tbl, keys, aggs, dropna)
    _assert_bits_equal(got, want)
    if case == "nan_value_stays_in_its_group":
        s = got.to_pandas()["x_sum"].to_numpy()
        assert np.isnan(s[2]) and np.isfinite(np.delete(s, 2)).all()
    if case == "2048_slots":
        assert got.num_rows == 2048
    if case == "int64_sum_wraps":  # the int64 sum wraps as two's complement
        want_sums = [sum(int(v) for v in df.big[df.k == g]) for g in range(3)]
        wrapped = [(s + 2**63) % 2**64 - 2**63 for s in want_sums]
        assert got.to_pandas()["big_sum"].tolist() == wrapped


def _padded_table(n, cap, rng):
    """A table whose capacity passes its length, with NaN, huge values,
    out-of-range keys and set validity in the padding rows."""
    k = torch.from_numpy(rng.integers(0, 6, cap).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=cap))
    i = torch.from_numpy(rng.integers(-9, 9, cap))
    kv = torch.from_numpy(rng.random(cap) < 0.9)
    xv = torch.from_numpy(rng.random(cap) < 0.8)
    k[n:], x[n:], i[n:], kv[n:], xv[n:] = 1000, float("nan"), 2**62, True, True
    return tt.Table({"k": Column(tdt.int32, k, kv, n), "x": Column(tdt.float64, x, xv, n),
                     "i": Column(tdt.int64, i, None, n)})


@pytest.mark.parametrize("dropna", [True, False])
def test_dense_lane_reads_the_length_not_the_capacity(monkeypatch, dropna):
    tbl = _padded_table(1000, 4096, np.random.default_rng(5))
    got, want = _dense_and_sort(monkeypatch, tbl, ["k"], _all_kinds("x", "i"), dropna)
    _assert_bits_equal(got, want)
    assert got.num_rows == (6 if dropna else 7)


def _refused(name):
    rng = np.random.default_rng(11)
    n = 3000
    if name == "2049_slots":
        df = pd.DataFrame({"k": np.r_[np.arange(2049), np.zeros(n - 2049, np.int64)],
                           "x": rng.normal(size=n)})
        return df, ["k"], _specs(("x", "sum", "s"))
    if name == "one_value_column_past_the_limit":
        cols = {f"v{j}": rng.normal(size=n) for j in range(K.MAX_VALUES + 1)}
        df = pd.DataFrame({"k": rng.integers(0, 4, n), **cols})
        return df, ["k"], _specs(*[(c, "sum", c + "_s") for c in cols])
    if name == "accumulators_past_shared_memory":
        # 2048 slots x (1 + 2 x 7) accumulators of 8 B: 240 KB a warp
        cols = {f"v{j}": _nulls(rng, rng.normal(size=n), 0.1) for j in range(7)}
        df = pd.DataFrame({"k": np.r_[np.arange(2048), np.zeros(n - 2048, np.int64)], **cols})
        return df, ["k"], _specs(*[(c, "mean", c + "_m") for c in cols])
    if name == "a_kind_it_does_not_take":
        df = pd.DataFrame({"k": rng.integers(0, 4, n), "x": rng.normal(size=n)})
        return df, ["k"], _specs(("x", "sum", "s"), ("x", "min", "lo"))
    if name == "a_count_of_strings":
        df = pd.DataFrame({"k": rng.integers(0, 4, n),
                           "s": np.array(["a", "b"], object)[rng.integers(0, 2, n)],
                           "x": rng.normal(size=n)})
        return df, ["k"], _specs(("x", "sum", "xs"), ("s", "count", "sc"))
    raise KeyError(name)


@pytest.mark.parametrize("case", ["2049_slots", "one_value_column_past_the_limit",
                                  "accumulators_past_shared_memory", "a_kind_it_does_not_take",
                                  "a_count_of_strings"])
def test_what_the_dense_lane_refuses_reaches_the_sort_lane(monkeypatch, case):
    df, keys, aggs = _refused(case)
    tbl = tt.Table.from_pandas(df, device="cpu")
    lanes = _Lanes(monkeypatch)
    kernel_calls = []
    inner = K.dense_groupby
    monkeypatch.setattr(K, "dense_groupby",
                        lambda *a, **k: kernel_calls.append(1) or inner(*a, **k))
    got = tgb.groupby_aggregate(tbl, keys, aggs)
    assert lanes.dense == [False] and lanes.sort == [True] and kernel_calls == []
    want = sortgroup.sort_groupby(tbl, keys, aggs, True)
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("case", ["no_rows", "dropped_to_no_rows"])
def test_dense_lane_launches_nothing_on_no_rows(monkeypatch, case):
    """A table with no rows takes the dense lane and returns no groups with
    the sort lane's columns and dtypes, calling no kernel."""
    n = 0 if case == "no_rows" else 40
    df = pd.DataFrame({"k": pd.arrays.IntegerArray(np.zeros(n, np.int32), np.ones(n, bool)),
                       "x": np.ones(n), "i": np.arange(n, dtype=np.int32)})
    tbl = tt.Table.from_pandas(df, device="cpu")
    if case == "dropped_to_no_rows":
        tbl = tsc.drop_nulls(tbl)
    assert tbl.num_rows == 0
    kernel_calls = []
    inner = K.dense_groupby
    monkeypatch.setattr(K, "dense_groupby",
                        lambda *a, **k: kernel_calls.append(1) or inner(*a, **k))
    got, want = _dense_and_sort(monkeypatch, tbl, ["k"], _all_kinds("x", "i"), True)
    assert kernel_calls == [] and got.num_rows == 0
    _assert_bits_equal(got, want)


def test_a_groupby_the_dense_lane_takes_does_not_chunk(monkeypatch):
    """Past the memory a sorted lane's working set may use, the dense lane
    takes the groupby whole (it holds no working set); with the dense lane
    switched off the same groupby chunks. Both equal the unchunked sort
    lane's answer."""
    from cudf_tpu_torch.ops import chunked

    df, keys, aggs = _case("two_keys", n=12000)
    tbl = tt.Table.from_pandas(df, device="cpu")
    monkeypatch.setattr(chunked, "CPU_LIMIT_BYTES", 300_000)
    assert chunked.chunk_rows(tbl, chunked.GROUPBY_FACTOR) is not None
    before = chunked.runs["groupby"]
    lanes = _Lanes(monkeypatch)
    got = tgb.groupby_aggregate(tbl, keys, aggs, True)
    assert chunked.runs["groupby"] == before and lanes.dense == [True]
    monkeypatch.setattr(densegroup, "dense_groupby", lambda *a, **k: None)
    chunked_out = tgb.groupby_aggregate(tbl, keys, aggs, True)
    assert chunked.runs["groupby"] == before + 1
    monkeypatch.setattr(chunked, "CPU_LIMIT_BYTES", None)
    want = tgb.groupby_aggregate(tbl, keys, aggs, True)
    _assert_bits_equal(got, want)
    pd.testing.assert_frame_equal(chunked_out.to_pandas(), want.to_pandas(), rtol=1e-12)


@pytest.mark.parametrize("lane", ["onehot", "dense", "sort"])
def test_past_the_memory_limit_only_the_dense_lane_runs_whole(monkeypatch, lane):
    """The lane order is stated once: past the memory limit a groupby the
    one-hot lane (one float32 column) or the sort lane (a ``min``) takes
    runs chunk by chunk, one the dense lane takes runs whole, and
    ``aggregate_in_memory`` never chunks. Each answer equals the unchunked
    one (the values are whole numbers, so every order sums them exactly)."""
    from cudf_tpu_torch.ops import chunked

    rng = np.random.default_rng(7)
    n = 12000
    x = rng.integers(0, 100, n).astype(np.float32 if lane == "onehot" else np.float64)
    df = pd.DataFrame({"a": rng.integers(0, 3, n).astype(np.int32),
                       "b": rng.integers(0, 2, n).astype(np.int32), "x": x})
    kinds = ["sum", "mean", "count"] + (["min"] if lane == "sort" else [])
    aggs = _specs(*[("x", kind, kind) for kind in kinds], ("", "size", "n"))
    tbl = tt.Table.from_pandas(df, device="cpu")
    assert (tgb._onehot_plan(tbl, ["a", "b"], aggs) is not None) == (lane == "onehot")
    want = tgb.groupby_aggregate(tbl, ["a", "b"], aggs).to_pandas()
    monkeypatch.setattr(chunked, "CPU_LIMIT_BYTES", 100_000)
    assert chunked.chunk_rows(tbl, chunked.GROUPBY_FACTOR) is not None
    before = chunked.runs["groupby"]
    got = tgb.groupby_aggregate(tbl, ["a", "b"], aggs).to_pandas()
    assert chunked.runs["groupby"] - before == (0 if lane == "dense" else 1)
    whole = tgb.aggregate_in_memory(tbl, ["a", "b"], aggs).to_pandas()
    assert chunked.runs["groupby"] - before == (0 if lane == "dense" else 1)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(whole, want)


# ---------------------------------------------------------------- the kernel
@pytest.mark.parametrize("slots,accs,want", [
    (8, 6, 0), (16, 3, 0), (32, 1, 0), (1, 16, 0), (8, 7, 8), (1, 17, 8), (128, 4, 8),
    (2048, 2, 7), (2048, 14, 1), (2048, 15, None), (4096, 1, None), (1, K.MAX_ACCS + 1, None),
    (8, -2, 8), (2, -3, 8)])
def test_tier_by_slots_and_accumulators(slots, accs, want):
    """``accs`` float64 sums beside the row count (``-m``: m sums, one of
    them an integer one, which takes the warp tier)."""
    kinds = [K.ROWS] + [K.SUM_F] * (abs(accs) - 1)
    if accs < 0:
        kinds[-1] = K.SUM_I
    assert K.tier(slots, kinds) == want


def _small_inputs():
    d = torch.arange(10, dtype=torch.int32)
    return [K.Key(d, None, 0, 4, 10, 10)], [K.Acc(K.ROWS), K.Acc(K.SUM_F, d.double())]


@pytest.mark.parametrize("fault", ["float16_key", "int_sum_of_floats", "float_sum_of_ints",
                                   "count_without_validity", "too_few_rows", "strided",
                                   "slots_for_other_widths", "no_keys"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    keys, accs = _small_inputs()
    n, slots = 10, 16
    d = keys[0].data
    if fault == "float16_key":
        keys = [K.Key(d.half(), None, 0, 4, 10, 10)]
    elif fault == "int_sum_of_floats":
        accs = [K.Acc(K.ROWS), K.Acc(K.SUM_I, d.double())]
    elif fault == "float_sum_of_ints":
        accs = [K.Acc(K.ROWS), K.Acc(K.SUM_F, d)]
    elif fault == "count_without_validity":
        accs = [K.Acc(K.ROWS), K.Acc(K.COUNT, d)]
    elif fault == "too_few_rows":
        n = 11
    elif fault == "strided":
        accs = [K.Acc(K.ROWS), K.Acc(K.SUM_F, torch.arange(20.0, dtype=torch.float64)[::2])]
    elif fault == "slots_for_other_widths":
        slots = 32
    elif fault == "no_keys":
        keys = []
    with pytest.raises((TypeError, ValueError)):
        K.dense_groupby(keys, accs, n, slots, True)


def test_plain_version_folds_each_slot_in_row_order():
    """Each slot's float sum is its rows' values added left to right,
    starting from 0, in float64: the bits of Python's own fold."""
    rng = np.random.default_rng(2)
    n = 5000
    k = torch.from_numpy(rng.integers(0, 5, n))
    x = torch.from_numpy(rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n))
    out = K.dense_groupby([K.Key(k, None, 0, 3, 5, 5)], [K.Acc(K.ROWS), K.Acc(K.SUM_F, x)],
                          n, 8, True)
    for g in range(5):
        acc = 0.0
        for v in x[k == g].tolist():
            acc += v
        assert out[g, 1].view(torch.float64).item() == acc
        assert out[g, 0].item() == int((k == g).sum())
    assert (out[5:] == 0).all()


# ------------------------------------------------------------------ the card
def _card_case(n, slots_bits, dtypes, null_share, seed, dev):
    """Keys over ``slots_bits`` bits (a nullable int32 key and, past 3 bits,
    a float64 key with NaN) and one value column of each dtype; values k /
    2^20 for float columns, so an int64 sum of k is their exact sum."""
    gen = torch.Generator().manual_seed(seed)
    w0 = min(slots_bits, 3)  # a key codes in one bit at least
    keys = [K.Key(torch.randint(-1, (1 << w0) - 2, (n,), generator=gen, dtype=torch.int32),
                  torch.rand(n, generator=gen) > null_share, -1, w0, (1 << w0) - 1,
                  (1 << w0) - 1)]
    if slots_bits > w0:
        w1 = slots_bits - w0
        f = torch.randint(0, (1 << w1) - 1, (n,), generator=gen).double()
        f[torch.rand(n, generator=gen) < 0.05] = float("nan")
        keys.append(K.Key(f, None, 0.0, w1, (1 << w1) - 1, 1 << w1))
    accs, exact = [K.Acc(K.ROWS)], []
    for dt in dtypes:
        valid = (torch.rand(n, generator=gen) > null_share) if null_share else None
        if dt.is_floating_point:
            ki = torch.randint(-2**30, 2**30, (n,), generator=gen)
            data = (ki.double() / 2**20).to(dt)
            if dt == torch.float64:
                exact.append((len(accs), ki))
            accs.append(K.Acc(K.SUM_F, data, valid))
        else:
            data = torch.randint(-2**62 if dt == torch.int64 else -100,
                                 2**62 if dt == torch.int64 else 100, (n,), generator=gen)
            accs.append(K.Acc(K.SUM_I, data.to(dt), valid))
        if valid is not None:
            accs.append(K.Acc(K.COUNT, None, valid))
    return keys, accs, exact


def _to(dev, keys, accs):
    move = (lambda t: None if t is None else t.to(dev))
    return ([K.Key(move(k.data), move(k.validity), k.vmin, k.width, k.nan_code, k.null_code)
             for k in keys], [K.Acc(a.kind, move(a.data), move(a.validity)) for a in accs])


CARD_SHAPES = [  # (rows, slot bits, value dtypes, null share): both tiers
    (1_000_003, 3, (torch.float64,) * 5, 0.0),             # TPC-H Q1's: the thread tier
    (1_000_003, 2, (torch.float64, torch.float32, torch.bfloat16), 0.2),  # thread tier, nulls
    (1_000_003, 1, (torch.float64, torch.int64), 0.1),     # one slot and the nulls' slot
    (777_777, 2, (torch.int32, torch.float32, torch.bfloat16, torch.int8), 0.2),
    (1_000_003, 7, (torch.int32, torch.int32, torch.float64), 0.0),  # h2o q4's: warp tier
    (2_000_001, 11, (torch.float64, torch.int64), 0.1),    # 2048 slots
    (5, 4, (torch.float64,) * 15, 0.5),                    # A = 31: warp tier, a few rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(CARD_SHAPES)))
@pytest.mark.parametrize("dropna", [True, False])
def test_kernel_against_its_plain_version_on_the_card(shape, dropna):
    """The plain version runs on the CPU copies of the inputs. Row counts,
    valid counts and integer sums in equal bits; a float64 sum within
    (m - 1)·eps·Σ|x| of the exact sum of its slot's m terms (any order of
    the terms), a float32 or bfloat16 column's sum within that of the
    plain version's; the same bits on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only there")
    n, bits, dts, nulls = CARD_SHAPES[shape]
    keys, accs, exact = _card_case(n, bits, dts, nulls, 100 + shape, "cpu")
    slots = 1 << sum(k.width for k in keys)
    dkeys, daccs = _to(torch.device("cuda"), keys, accs)
    before = K.dense_groupby.launches
    got = K.dense_groupby(dkeys, daccs, n, slots, dropna).cpu()
    again = K.dense_groupby(dkeys, daccs, n, slots, dropna).cpu()
    assert K.dense_groupby.launches - before == 2
    assert torch.equal(got, again)
    want = K.dense_groupby_plain(keys, accs, n, slots, dropna)
    eps = 2.0 ** -53
    for j, a in enumerate(accs):
        if a.kind != K.SUM_F:
            assert torch.equal(got[:, j], want[:, j]), (shape, j)
            continue
        g, w = got[:, j].view(torch.float64), want[:, j].view(torch.float64)
        terms = K.Acc(K.SUM_F, a.data.abs().double(), a.validity)
        absum = K.dense_groupby_plain(keys, [K.Acc(K.ROWS), terms], n, slots,
                                      dropna)[:, 1].view(torch.float64)
        m = want[:, 0].double()
        ref = w
        for jj, ki in exact:
            if jj == j:  # the exact sum: int64 sum of k, over 2^20
                ref = K.dense_groupby_plain(keys, [K.Acc(K.ROWS), K.Acc(K.SUM_I, ki, a.validity)],
                                            n, slots, dropna)[:, 1].double() / 2**20
        slack = 2 if ref is w else 1  # against the plain version: both sums' errors
        assert bool(((g - ref).abs() <= slack * (m * eps * absum) + 1e-300).all()), (shape, j)


@pytest.mark.cuda
def test_kernel_at_tpch_q1s_shape_on_the_card():
    """177M rows of two int32 code keys (8 slots) and five float64 columns,
    as TPC-H Q1 at SF30 hands them to the lane: counts equal the plain
    version's on the card, sums within the bound, the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only there")
    dev = torch.device("cuda")
    n, cap = 177_000_000, 1 << 28
    gen = torch.Generator(device=dev).manual_seed(1)
    flag = torch.randint(0, 3, (cap,), device=dev, generator=gen, dtype=torch.int32)
    status = torch.randint(0, 2, (cap,), device=dev, generator=gen, dtype=torch.int32)
    keys = [K.Key(flag, None, 0, 2, 3, 3), K.Key(status, None, 0, 1, 2, 2)]
    ks = [torch.randint(0, 2**30, (cap,), device=dev, generator=gen) for _ in range(5)]
    accs = [K.Acc(K.ROWS)] + [K.Acc(K.SUM_F, k.double() / 2**20) for k in ks]
    got = K.dense_groupby(keys, accs, n, 8, True)
    assert torch.equal(got, K.dense_groupby(keys, accs, n, 8, True))
    rows = torch.bincount((flag[:n] * 2 + status[:n]).long(), minlength=8)
    assert torch.equal(got[:, 0], rows)
    for j, k in enumerate(ks, 1):
        exact = K.dense_groupby(keys, [K.Acc(K.ROWS), K.Acc(K.SUM_I, k)], n, 8, True)[:, 1]
        exact = exact.double() / 2**20
        bound = rows.double() * 2.0**-53 * exact.abs()  # the terms are non-negative
        assert bool(((got[:, j].view(torch.float64) - exact).abs() <= bound).all()), j
    assert math.isclose(float(got[:, 0].sum()), n)
