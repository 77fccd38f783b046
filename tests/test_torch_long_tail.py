"""The port's pack, bloom filter, t-digest and HLL ops (``ops/pack.py``,
``ops/bloom.py``, ``ops/tdigest.py``) against cudf_tpu's.

Tolerances: packed blobs byte-identical to the reference's and unpacked
exactly by either package; bloom bits equal to the reference's for numeric
keys, with no false negatives; t-digest centroids rtol 1e-9 against the
reference (weights exact); quantiles and HLL estimates within the
reference tests' bounds (``tests/test_tdigest.py``), HLL registers equal.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.ops import bloom as RB
from cudf_tpu.ops import pack as RP
from cudf_tpu.ops import tdigest as RT

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import categorical as tcat
from cudf_tpu_torch.ops import bloom as TB
from cudf_tpu_torch.ops import pack as TP
from cudf_tpu_torch.ops import tdigest as TT


def _frame(n=137, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "i": rng.integers(-9, 9, n).astype(np.int64),
        "i8": rng.integers(-9, 9, n).astype(np.int8),
        "u": rng.integers(0, 9, n).astype(np.uint32),
        "f": rng.standard_normal(n),
        "f32": rng.standard_normal(n).astype(np.float32),
        "b": rng.random(n) > 0.5,
        "s": rng.choice(["x", "yy", "zzz", "é"], n),
        "t": pd.to_datetime("2020-01-01") + pd.to_timedelta(rng.integers(0, 999, n), "D"),
        "m": pd.array(rng.integers(0, 5, n), dtype="Int32"),
    })
    df.loc[rng.random(n) < 0.2, "m"] = pd.NA
    df.loc[rng.random(n) < 0.1, "s"] = None
    return df


# ------------------------------------------------------------------- pack
def test_pack_blobs_are_the_references_byte_for_byte():
    df = _frame()
    r, t = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    pr, pt = RP.pack(r), TP.pack(t)
    assert pt.metadata == pr.metadata and pt.buffer == pr.buffer
    assert pt.nbytes == pr.nbytes
    want = r.to_pandas()
    pd.testing.assert_frame_equal(TP.unpack(pr, device="cpu").to_pandas(), want)
    pd.testing.assert_frame_equal(RP.unpack(pt).to_pandas(), want)
    back = TP.unpack(pt, device="cpu")
    for name, c in t:
        assert back[name].dtype == c.dtype
        np.testing.assert_array_equal(back[name].data[: c.length].numpy(),
                                      c.data[: c.length].numpy())


def test_pack_keeps_a_categorical():
    """The reference's unpack turns a categorical into strings; the port
    keeps its codes, categories and order."""
    cat = pd.Series(pd.Categorical(["lo", "hi", None, "hi"], categories=["lo", "hi"],
                                   ordered=True))
    df = pd.DataFrame({"c": cat})
    t = tt.Table.from_pandas(df, device="cpu")
    back = TP.unpack(TP.pack(t), device="cpu")
    assert tcat.is_categorical(back["c"]) and tcat.ordered(back["c"])
    pd.testing.assert_series_equal(back.to_pandas()["c"], cat, check_names=False)
    ref = RP.unpack(RP.pack(ct.Table.from_pandas(df)))["c"]
    assert ref.dtype.is_string


def test_contiguous_split_and_chunked_pack():
    df = _frame(57, seed=1)
    r, t = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    for got, want in zip(TP.contiguous_split(t, [10, 40]), RP.contiguous_split(r, [10, 40])):
        assert got.buffer == want.buffer and got.metadata == want.metadata
    chunks = list(TP.chunked_pack(t, 25))
    assert [TP.unpack(c, device="cpu").num_rows for c in chunks] == [25, 25, 7]
    cat = np.concatenate([TP.unpack(c, device="cpu")["i"].to_numpy() for c in chunks])
    np.testing.assert_array_equal(cat, df.i)
    empty = tt.Table.from_pandas(df.iloc[:0], device="cpu")
    assert TP.unpack(TP.pack(empty), device="cpu").num_rows == 0
    assert list(TP.chunked_pack(empty, 4))[0].buffer == b""


# ------------------------------------------------------------------ bloom
@pytest.mark.parametrize("key", ["i", "f", "u"])
def test_bloom_bits_equal_the_reference_and_no_false_negatives(key):
    rng = np.random.default_rng(2)
    build = pd.DataFrame({"i": rng.integers(0, 1 << 40, 3000),
                          "f": rng.standard_normal(3000),
                          "u": rng.integers(0, 1 << 30, 3000).astype(np.uint32)})
    probe = pd.concat([build.sample(500, random_state=1),
                       pd.DataFrame({"i": rng.integers(0, 1 << 40, 2000),
                                     "f": rng.standard_normal(2000),
                                     "u": rng.integers(0, 1 << 30, 2000).astype(np.uint32)})])
    rb = RB.build([ct.Table.from_pandas(build)[key]], 15, 3)
    tb = TB.build([tt.Table.from_pandas(build, device="cpu")[key]], 15, 3)
    np.testing.assert_array_equal(tb.bits.numpy(), np.asarray(rb.bits))
    got = TB.maybe_contains(tb, [tt.Table.from_pandas(probe, device="cpu")[key]]).to_numpy()
    want = RB.maybe_contains(rb, [ct.Table.from_pandas(probe)[key]]).to_numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:500].all()


def test_bloom_merge_and_two_keys():
    a = pd.DataFrame({"k": np.arange(0, 100), "g": np.arange(0, 100) % 3})
    b = pd.DataFrame({"k": np.arange(100, 200), "g": np.arange(100, 200) % 3})
    fa = TB.build(list(tt.Table.from_pandas(a, device="cpu").columns), 14, 3)
    fb = TB.build(list(tt.Table.from_pandas(b, device="cpu").columns), 14, 3)
    m = TB.merge([fa, fb])
    probe = tt.Table.from_pandas(pd.concat([a, b]), device="cpu")
    assert TB.maybe_contains(m, probe.columns).to_numpy().all()
    ra = RB.build(list(ct.Table.from_pandas(a).columns), 14, 3)
    np.testing.assert_array_equal(fa.bits.numpy(), np.asarray(ra.bits))


def test_bloom_string_keys_on_two_dictionaries():
    """The reference hashes a string's dictionary code, so a probe column
    on another dictionary than the build's gets false negatives; the port
    hashes the value and finds every key."""
    build = pd.DataFrame({"s": [f"k{i:03d}" for i in range(0, 400, 2)]})
    probe = pd.DataFrame({"s": [f"k{i:03d}" for i in range(400)]})
    tb = TB.build([tt.Table.from_pandas(build, device="cpu")["s"]], 14, 3)
    got = TB.maybe_contains(tb, [tt.Table.from_pandas(probe, device="cpu")["s"]]).to_numpy()
    assert got[::2].all()
    rb = RB.build([ct.Table.from_pandas(build)["s"]], 14, 3)
    ref = RB.maybe_contains(rb, [ct.Table.from_pandas(probe)["s"]]).to_numpy()
    assert not ref[::2].all()
    shared = TB.maybe_contains(tb, [tt.Table.from_pandas(build, device="cpu")["s"]])
    assert shared.to_numpy().all()


def test_bloom_key_with_a_mask_probed_against_one_without():
    """The reference hashes a masked column's null-flag word, so a key
    probed from a column with a mask misses the same key built without."""
    keys = np.arange(1000, dtype=np.int64)
    build = pd.DataFrame({"k": keys})
    probe = pd.DataFrame({"k": pd.array(keys, dtype="Int64")})
    probe.loc[::7, "k"] = pd.NA
    tb = TB.build([tt.Table.from_pandas(build, device="cpu")["k"]], 14, 3)
    got = TB.maybe_contains(tb, [tt.Table.from_pandas(probe, device="cpu")["k"]]).to_numpy()
    valid = probe["k"].notna().to_numpy()
    assert got[valid].all()
    rb = RB.build([ct.Table.from_pandas(build)["k"]], 14, 3)
    ref = RB.maybe_contains(rb, [ct.Table.from_pandas(probe)["k"]]).to_numpy()
    assert not ref[valid].all()


# ---------------------------------------------------------------- t-digest
def _col(x, validity=None):
    return ct.Column.from_numpy(x, validity), tt.Column.from_numpy(x, validity, device="cpu")


@pytest.mark.parametrize("delta", [50, 200])
def test_tdigest_centroids_equal_the_reference(delta):
    x = np.random.default_rng(3).standard_normal(20_000)
    r, t = _col(x)
    rs, ts = RT.tdigest(r, delta), TT.tdigest(t, delta)
    np.testing.assert_array_equal(ts.weights.numpy(), np.asarray(rs.weights))
    np.testing.assert_allclose(ts.means.numpy(), np.asarray(rs.means), rtol=1e-9, atol=1e-12)
    assert (ts.vmin, ts.vmax) == (float(rs.vmin), float(rs.vmax))
    qs = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]
    got = TT.tdigest_quantile(ts, qs).to_numpy()
    assert np.all(np.abs(got - np.quantile(x, qs)) < 0.05)


def test_tdigest_extremes_nulls_and_merge():
    x = np.array([5.0, 1.0, np.nan, 3.0, 2.0, 4.0])
    _, t = _col(x, np.array([True, True, True, True, False, True]))
    sk = TT.tdigest(t, 100)
    np.testing.assert_array_equal(TT.tdigest_quantile(sk, [0.0, 1.0]).to_numpy(), [1.0, 5.0])
    assert float(sk.weights.sum()) == 4.0
    rng = np.random.default_rng(1)
    parts = [rng.exponential(2.0, 20_000) for _ in range(4)]
    rsk = [RT.tdigest(ct.Column.from_numpy(p), 200) for p in parts]
    tsk = [TT.tdigest(tt.Column.from_numpy(p, device="cpu"), 200) for p in parts]
    rm, tm = RT.merge_tdigest(rsk, 200), TT.merge_tdigest(tsk, 200)
    np.testing.assert_array_equal(tm.weights.numpy(), np.asarray(rm.weights))
    np.testing.assert_allclose(tm.means.numpy(), np.asarray(rm.means), rtol=1e-9, atol=1e-12)
    qs = [0.1, 0.5, 0.9, 0.99]
    got = TT.tdigest_quantile(tm, qs).to_numpy()
    want = np.quantile(np.concatenate(parts), qs)
    assert np.all(np.abs(got - want) / np.abs(want) < 0.05)


# --------------------------------------------------------------------- HLL
@pytest.mark.parametrize("true_n", [100, 5_000, 60_000])
def test_hll_registers_equal_the_reference_and_estimates(true_n):
    rng = np.random.default_rng(true_n)
    x = rng.integers(0, true_n, 200_000).astype(np.int64)
    r, t = _col(x)
    np.testing.assert_array_equal(TT.hll_registers([t]).numpy(),
                                  np.asarray(RT._hll_registers((r,))))
    actual = len(np.unique(x))
    est = TT.approx_distinct_count([t])
    assert abs(est - actual) / actual < 0.05
    assert est == RT.approx_distinct_count([r])


def test_hll_merge_and_string_keys():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 3000, 50_000).astype(np.int64)
    b = rng.integers(2000, 6000, 50_000).astype(np.int64)
    regs = TT.hll_merge_registers([TT.hll_registers([tt.Column.from_numpy(v, device="cpu")])
                                   for v in (a, b)])
    actual = len(np.unique(np.concatenate([a, b])))
    assert abs(TT.hll_estimate(regs) - actual) / actual < 0.05
    s = pd.DataFrame({"s": np.array([f"v{i}" for i in rng.integers(0, 4000, 30_000)])})
    r, t = ct.Table.from_pandas(s)["s"], tt.Table.from_pandas(s, device="cpu")["s"]
    np.testing.assert_array_equal(TT.hll_registers([t]).numpy(),
                                  np.asarray(RT._hll_registers((r,))))
    assert TT.hll_registers([t]).dtype == torch.int32


@pytest.mark.parametrize("n", [10, 30])
def test_reference_quantiles_of_a_sparse_digest(n):
    """A digest of fewer values than centroids has empty slots between full
    ones; the reference binary-searches midpoints in which those read +inf,
    and its quantiles fall back to the first centroid (not monotone). The
    port interpolates over the full centroids: monotone, within one value of
    numpy's quantile."""
    x = np.arange(n, dtype=np.float64)
    qs = np.linspace(0, 1, 11)
    ref = RT.tdigest_quantile(RT.tdigest(ct.Column.from_numpy(x), 100), qs).to_numpy()
    got = TT.tdigest_quantile(TT.tdigest(tt.Column.from_numpy(x, device="cpu"), 100),
                              qs).to_numpy()
    assert (np.diff(got) >= 0).all() and np.abs(got - np.quantile(x, qs)).max() <= 1.0
    assert (np.diff(ref) < 0).any() or np.abs(ref - np.quantile(x, qs)).max() > 1.0
