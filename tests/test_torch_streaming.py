"""Out-of-core execution on the port (``ops/streaming_groupby.py``,
``ops/chunked.py``, ``parallel/partitioned.py``) against cudf_tpu's, on
the same seeded frames (the port on the CPU).

* ``streaming_groupby`` for every aggregation it merges, against the
  reference's and the port's single-pass ``groupby_aggregate``;
* ``PartitionedFrame`` under a tiny budget: groupby, ``join_small``,
  ``read_parquet_chunked`` and ``sort_values``. The port's ``sort_values``
  must equal ``sort_by_key`` of the concatenated partitions exactly, NaN
  and null keys, every flag; the reference loses rows whose first key is
  NaN or null, and its descending sort is not ordered (both pinned);
* the chunked branches of ``sort_by_key``, ``groupby_aggregate`` and the
  compactions, forced on the CPU by ``chunked.CPU_LIMIT_BYTES`` (or an
  installed budget), against the port's unchunked ops and the reference's
  chunked ones (its ``CHUNK_ENVELOPE`` monkeypatched).

Tolerances: keys, counts, row order, min/max exact; f64 sums and means
rtol 1e-12 (summed in another order); var/std rtol 1e-8 (merged moments,
the reference's own ``tests/test_streaming.py`` tolerance); f32 sums, means
and std rtol 1e-5 (each partial rounds to f32; ``test_torch_groupby.py``'s
f32 tolerance).
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import chunked as rchunked
from cudf_tpu.ops import sorting as rsorting
from cudf_tpu.ops import stream_compaction as rsc
from cudf_tpu.ops.groupby import AggSpec as RAgg
from cudf_tpu.ops.groupby import groupby_aggregate as rgroupby
from cudf_tpu.ops.streaming_groupby import streaming_groupby as rstreaming
from cudf_tpu.parallel.partitioned import PartitionedFrame as RPF

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import chunked
from cudf_tpu_torch.ops import sorting as tsorting
from cudf_tpu_torch.ops import stream_compaction as tsc
from cudf_tpu_torch.ops.copying import concatenate_tables
from cudf_tpu_torch.ops.groupby import AggSpec as TAgg
from cudf_tpu_torch.ops.groupby import groupby_aggregate as tgroupby
from cudf_tpu_torch.ops.streaming_groupby import streaming_groupby as tstreaming
from cudf_tpu_torch.parallel.partitioned import PartitionedFrame as TPF
from cudf_tpu_torch.utils import hbm as thbm
from cudf_tpu_torch.utils.hbm import table_device_bytes

EXACT = {"count", "size", "min", "max", "any", "all"}


def _rtol(kind):
    return 1e-8 if kind in ("var", "std") else 1e-12


def _frame(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n)
    v[rng.random(n) < 0.05] = np.nan
    k = pd.array(rng.integers(0, 20, n), dtype="Int64")
    k[rng.random(n) < 0.03] = pd.NA
    return pd.DataFrame({"k": k, "v": pd.array(v, dtype="Float64"),
                         "b": rng.random(n) < 0.4})


def _parts(df, n_parts):
    pieces = [df.iloc[i::n_parts].reset_index(drop=True) for i in range(n_parts)]
    return ([ct.Table.from_pandas(p) for p in pieces],
            [tt.Table.from_pandas(p, device="cpu") for p in pieces])


AGGS = [("sum", "v"), ("mean", "v"), ("count", "v"), ("size", ""), ("min", "v"),
        ("max", "v"), ("var", "v"), ("std", "v"), ("any", "b"), ("all", "b")]


@pytest.mark.parametrize("kind,column", AGGS)
@pytest.mark.parametrize("dropna", [True, False])
def test_streaming_groupby_each_agg(kind, column, dropna):
    df = _frame()
    rparts, tparts = _parts(df, 7)
    ref = rstreaming(rparts, ["k"], [RAgg(column, kind, "out")], dropna).to_pandas()
    got = tstreaming(tparts, ["k"], [TAgg(column, kind, "out")], dropna).to_pandas()
    single = tgroupby(tt.Table.from_pandas(df, device="cpu"), ["k"],
                      [TAgg(column, kind, "out")], dropna).to_pandas()
    rtol = 0 if kind in EXACT else _rtol(kind)
    pd.testing.assert_frame_equal(got, ref, check_dtype=False, rtol=rtol, atol=0)
    pd.testing.assert_frame_equal(got, single, check_dtype=False, rtol=rtol, atol=0)


def test_streaming_tree_reduction_many_parts():
    rng = np.random.default_rng(1)
    df = pd.DataFrame({"k": rng.integers(0, 5, 4000), "v": np.ones(4000)})
    rparts, tparts = _parts(df, 67)
    got = tstreaming(tparts, ["k"], [TAgg("v", "sum", "s")], n_ary=4).to_pandas()
    ref = rstreaming(rparts, ["k"], [RAgg("v", "sum", "s")], n_ary=4).to_pandas()
    pd.testing.assert_frame_equal(got, ref)
    assert got["s"].sum() == 4000


def test_streaming_groupby_rejects_what_does_not_merge():
    with pytest.raises(ValueError, match="median"):
        tstreaming([tt.Table.from_pandas(_frame(100), device="cpu")], ["k"],
                   [TAgg("v", "median", "m")])


# ------------------------------------------------------------ partitioned frame
@pytest.fixture
def tiny_budget():
    b = thbm.HbmBudget(64 * 1024)
    thbm.set_hbm_budget(b)
    yield b
    thbm.set_hbm_budget(None)


def test_groupby_agg_under_a_tiny_budget(tiny_budget):
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"k": rng.integers(0, 10, 30000), "v": rng.normal(size=30000)})
    aggs = [("v", "mean", "m"), ("v", "sum", "s"), ("", "size", "n")]
    ref = RPF.from_pandas(df, npartitions=5).groupby_agg(
        ["k"], [RAgg(*a) for a in aggs]).to_pandas()
    pf = TPF.from_pandas(df, npartitions=5, device="cpu")
    got = pf.map_partitions(tsc.drop_nulls).groupby_agg(
        ["k"], [TAgg(*a) for a in aggs]).to_pandas()
    assert tiny_budget.spill_count > 0 and tiny_budget.used <= tiny_budget.budget
    pd.testing.assert_frame_equal(got, ref, rtol=1e-12)
    want = df.groupby("k", as_index=False).agg(m=("v", "mean"), s=("v", "sum"),
                                                n=("v", "size"))
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-12)


def test_join_small_each_partition(tiny_budget):
    rng = np.random.default_rng(3)
    fact = pd.DataFrame({"k": rng.integers(0, 40, 12000), "v": rng.normal(size=12000)})
    dim = pd.DataFrame({"k": np.arange(30), "w": np.arange(30) * 2.0})
    ref = RPF.from_pandas(fact, npartitions=4).join_small(
        ct.Table.from_pandas(dim), ["k"], ["k"]).to_pandas()
    got = TPF.from_pandas(fact, npartitions=4, device="cpu").join_small(
        tt.Table.from_pandas(dim, device="cpu"), ["k"], ["k"]).to_pandas()
    assert tiny_budget.spill_count > 0
    pd.testing.assert_frame_equal(got, ref)  # each partition in left-row order
    want = fact.merge(dim, on="k")
    pd.testing.assert_frame_equal(got.sort_values(["k", "v"]).reset_index(drop=True),
                                  want.sort_values(["k", "v"]).reset_index(drop=True))


def test_read_parquet_chunked_partitions(tmp_path):
    df = pd.DataFrame({"a": np.arange(10000), "b": np.arange(10000) * 0.5,
                       "s": np.array([f"x{i % 13}" for i in range(10000)], object)})
    p = str(tmp_path / "big.parquet")
    df.to_parquet(p, row_group_size=1000)
    ref = RPF.read_parquet_chunked(p, rows_per_chunk=1000)
    got = TPF.read_parquet_chunked(p, rows_per_chunk=1000, device="cpu")
    assert got.npartitions == ref.npartitions == 10 and got.num_rows() == 10000
    pd.testing.assert_frame_equal(got.collect().to_pandas(), ref.collect().to_pandas())
    pd.testing.assert_frame_equal(got.to_pandas(), df)
    sel = TPF.read_parquet_chunked(p, rows_per_chunk=4000, columns=["b"], device="cpu")
    assert sel.npartitions == 3
    pd.testing.assert_frame_equal(sel.to_pandas(), df[["b"]])


def test_partitioned_entry_points_default_to_cuda(tmp_path):
    import torch

    df = pd.DataFrame({"a": [1, 2, 3]})
    if torch.cuda.is_available():
        assert TPF.from_pandas(df, 2).collect()["a"].device.type == "cuda"
        return
    p = str(tmp_path / "d.parquet")
    df.to_parquet(p)
    for call in (lambda: TPF.from_pandas(df, 2), lambda: TPF.read_parquet_chunked(p),
                 lambda: TPF.from_tables([tt.Table.from_pandas(df, device="cpu")]),
                 lambda: tt.io.read_parquet_chunked(p)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_from_tables_takes_cuda_for_the_current_card():
    """A frame on ``cuda`` (the default) holds tables on ``cuda:0``; a table
    on another device type is refused without a spill."""
    import torch

    from cudf_tpu_torch.parallel.partitioned import _same_device

    assert _same_device(torch.device("cuda:0"), torch.device("cuda"))
    assert not _same_device(torch.device("cuda:1"), torch.device("cuda:0"))
    assert not _same_device(torch.device("cpu"), torch.device("cuda"))
    t = tt.Table.from_pandas(pd.DataFrame({"a": [1]}), device="cpu")
    with pytest.raises(ValueError, match="in a frame on meta"):
        TPF.from_tables([t], spill=False, device="meta")


# ------------------------------------------------------------------ sort_values
def _sort_frame(kind, n=4000, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "nan":
        k = rng.integers(0, 30, n).astype(np.float64)
        k[rng.random(n) < 0.2] = np.nan
        k[rng.random(n) < 0.1] = -0.0
        return pd.DataFrame({"k": k, "j": rng.integers(0, 3, n), "v": np.arange(n)})
    if kind == "null":
        k = pd.array(rng.integers(0, 30, n), dtype="Int64")
        k[rng.random(n) < 0.25] = pd.NA
        return pd.DataFrame({"k": k, "j": rng.integers(0, 3, n), "v": np.arange(n)})
    if kind == "strings":
        # a string first key whose set of values drifts from row to row, so
        # that the contiguous partitions have different dictionaries
        words = np.array([f"w{i:03d}" for i in range(200)])
        k = words[(np.arange(n) * 160 // n + rng.integers(0, 40, n)) % 200]
        return pd.DataFrame({"k": k, "j": rng.integers(0, 3, n), "v": np.arange(n)})
    if kind == "null_in_one":
        # nulls in the first of five partitions only: the others carry no
        # validity mask
        k = pd.array(rng.integers(0, 30, n), dtype="Int64")
        k[(np.arange(n) < n // 5) & (rng.random(n) < 0.3)] = pd.NA
        return pd.DataFrame({"k": k, "j": rng.integers(0, 3, n), "v": np.arange(n)})
    # one heavy key (half the rows) and a string second key
    k = np.where(rng.random(n) < 0.5, 7, rng.integers(0, 1000, n))
    return pd.DataFrame({"k": k, "j": rng.choice(["a", "b", "c"], n), "v": np.arange(n)})


FLAGS = [(False, True), (True, True), (False, False), ([True, False], True),
         ([False, True], [False, True])]


@pytest.mark.parametrize("kind", ["nan", "null", "heavy", "strings", "null_in_one"])
@pytest.mark.parametrize("descending,nulls_last", FLAGS)
def test_sort_values_equals_sort_by_key(kind, descending, nulls_last):
    df = _sort_frame(kind)
    pf = TPF.from_pandas(df, npartitions=5, device="cpu")
    whole = concatenate_tables([p.get() for p in pf._parts])
    want = tsorting.sort_by_key(whole, ["k", "j"], descending, nulls_last).to_pandas()
    got = pf.sort_values(["k", "j"], descending, nulls_last).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == len(df)
    if kind == "nan":
        assert (np.signbit(got["k"].to_numpy()) == np.signbit(want["k"].to_numpy())).all()


def test_sort_values_of_partitions_that_differ_in_dictionary_and_mask():
    """The partitions of the string and null_in_one frames really differ:
    their own dictionaries, a mask in one partition only."""
    strings = TPF.from_pandas(_sort_frame("strings"), npartitions=5, device="cpu")
    dicts = [tuple(p.get()["k"].dictionary) for p in strings._parts]
    assert len(set(dicts)) == 5
    nulls = TPF.from_pandas(_sort_frame("null_in_one"), npartitions=5, device="cpu")
    assert [p.get()["k"].validity is not None for p in nulls._parts] == [True] + [False] * 4


def test_sort_values_refuses_categories_that_differ_by_partition():
    """A categorical key orders by its categories' positions, which no
    union can reconcile when partitions list different categories."""
    tables = [tt.Table.from_pandas(pd.DataFrame({"c": pd.Categorical(v)}), device="cpu")
              for v in (["b", "a"], ["c"])]
    with pytest.raises(ValueError, match="different categories"):
        TPF.from_tables(tables, device="cpu").sort_values(["c"])


@pytest.mark.parametrize("descending", [False, True])
def test_sort_values_of_read_parquet_chunked(tmp_path, descending):
    """Row groups with different string values and nulls in one row group
    only, read back one partition a row group."""
    rng = np.random.default_rng(8)
    n = 6000
    words = np.array([f"name{i:04d}" for i in range(500)])
    s = words[(np.arange(n) * 400 // n + rng.integers(0, 100, n)) % 500]
    i = pd.array(rng.integers(0, 50, n), dtype="Int64")
    i[(np.arange(n) >= 4000) & (rng.random(n) < 0.2)] = pd.NA
    df = pd.DataFrame({"s": s, "i": i, "v": rng.normal(size=n)})
    path = str(tmp_path / "d.parquet")
    df.to_parquet(path, row_group_size=1000)
    pf = TPF.read_parquet_chunked(path, rows_per_chunk=1000, device="cpu")
    assert pf.npartitions == 6
    whole = concatenate_tables([p.get() for p in pf._parts])
    for keys in (["s", "i"], ["i", "s"]):
        want = tsorting.sort_by_key(whole, keys, descending).to_pandas()
        got = pf.sort_values(keys, descending).to_pandas()
        pd.testing.assert_frame_equal(got, want)
        pandas = df.sort_values(keys, ascending=not descending, kind="stable",
                                na_position="last").reset_index(drop=True)
        pd.testing.assert_frame_equal(got, pandas, check_dtype=False)


def test_sort_values_under_a_tiny_budget(tiny_budget):
    df = _sort_frame("nan", n=20000)
    pf = TPF.from_pandas(df, npartitions=6, device="cpu")
    got = pf.sort_values(["k", "j"], [True, False]).to_pandas()
    assert tiny_budget.spill_count > 0
    thbm.set_hbm_budget(None)
    want = tsorting.sort_by_key(tt.Table.from_pandas(df, device="cpu"), ["k", "j"],
                                [True, False]).to_pandas()
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("kind", ["nan", "null"])
def test_reference_sort_values_loses_nan_and_null_rows(kind):
    df = _sort_frame(kind)
    ref = RPF.from_pandas(df, npartitions=4).sort_values(["k"]).to_pandas()
    got = TPF.from_pandas(df, npartitions=4, device="cpu").sort_values(["k"]).to_pandas()
    want = df.sort_values("k", kind="stable", na_position="last").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    assert len(ref) < len(df)


def test_reference_descending_sort_values_is_not_ordered():
    df = _sort_frame("nan").fillna(0.0)
    ref = RPF.from_pandas(df, npartitions=4).sort_values(["k"], descending=True).to_pandas()
    got = TPF.from_pandas(df, npartitions=4, device="cpu").sort_values(
        ["k"], descending=True).to_pandas()
    want = df.sort_values("k", ascending=False, kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    assert (np.diff(ref["k"].to_numpy()) > 0).any()


# ------------------------------------------------------------------ chunked ops
N_CHUNKED = 12000


@pytest.fixture
def chunking(monkeypatch):
    """The reference chunks at 4096 rows; the port's CPU limit is set so
    that its ops on these tables chunk too."""
    monkeypatch.setattr(rchunked, "CHUNK_ENVELOPE", 4096)
    monkeypatch.setattr(chunked, "CPU_LIMIT_BYTES", 300_000)
    before = dict(chunked.runs)
    yield lambda kind: chunked.runs[kind] - before[kind]


def _chunk_frame(seed=5):
    rng = np.random.default_rng(seed)
    n = N_CHUNKED
    k1 = rng.integers(0, 500, n).astype(np.float64)
    k1[rng.random(n) < 0.05] = np.nan
    k1[rng.random(n) < 0.05] = -0.0
    k2 = pd.array(rng.integers(0, 4, n), dtype="Int32")
    k2[rng.random(n) < 0.1] = pd.NA
    return pd.DataFrame({"k1": k1, "k2": k2, "v": rng.uniform(900.0, 105000.0, n),
                         "w": rng.uniform(900.0, 105000.0, n).astype(np.float32)})


def _unchunked(fn):
    old = chunked.CPU_LIMIT_BYTES
    chunked.CPU_LIMIT_BYTES = None
    try:
        return fn()
    finally:
        chunked.CPU_LIMIT_BYTES = old


@pytest.mark.parametrize("descending", [False, True, [True, False]])
def test_chunked_sort_equals_unchunked_and_reference(chunking, descending):
    df = _chunk_frame()
    t = tt.Table.from_pandas(df, device="cpu")
    want = _unchunked(lambda: tsorting.sort_by_key(t, ["k1", "k2"], descending)).to_pandas()
    got = tsorting.sort_by_key(t, ["k1", "k2"], descending).to_pandas()
    assert chunking("sort") == 1
    pd.testing.assert_frame_equal(got, want)
    assert (np.signbit(got["k1"].to_numpy()) == np.signbit(want["k1"].to_numpy())).all()
    if descending is False:  # the reference's chunked sort compiles for seconds a shape
        rchunked.DEVICE_SORT_CAPS.clear()
        ref = rsorting.sort_by_key(ct.Table.from_pandas(df), ["k1", "k2"]).to_pandas()
        assert rchunked.DEVICE_SORT_CAPS  # it took its chunked branch
        pd.testing.assert_frame_equal(got, ref, check_dtype=False)


def test_chunked_sort_of_one_heavy_key(chunking):
    df = _chunk_frame().assign(k1=7.0)
    t = tt.Table.from_pandas(df, device="cpu")
    want = _unchunked(lambda: tsorting.sort_by_key(t, ["k1"])).to_pandas()
    got = tsorting.sort_by_key(t, ["k1"]).to_pandas()
    assert chunking("sort") == 1
    pd.testing.assert_frame_equal(got, want)
    np.testing.assert_array_equal(got["v"], df["v"])  # one key: the input order, stable


Q1_AGGS = [("v", "sum", "sum_v"), ("w", "sum", "sum_w"), ("v", "mean", "avg_v"),
           ("w", "mean", "avg_w"), ("v", "count", "n_v"), ("", "size", "n"),
           ("v", "min", "lo"), ("w", "max", "hi"), ("v", "var", "var_v"), ("w", "std", "sd_w")]


@pytest.mark.parametrize("dropna", [True, False])
def test_chunked_groupby_equals_unchunked_and_reference(chunking, dropna):
    df = _chunk_frame().assign(k1=lambda d: (d["k1"].fillna(3) % 3).abs())
    t = tt.Table.from_pandas(df, device="cpu")
    aggs = [TAgg(*a) for a in Q1_AGGS]
    want = _unchunked(lambda: tgroupby(t, ["k1", "k2"], aggs, dropna)).to_pandas()
    got = tgroupby(t, ["k1", "k2"], aggs, dropna).to_pandas()
    assert chunking("groupby") == 1
    ref = rgroupby(ct.Table.from_pandas(df), ["k1", "k2"], [RAgg(*a) for a in Q1_AGGS],
                   dropna).to_pandas()
    for other in (want, ref):
        pd.testing.assert_frame_equal(got[["k1", "k2", "n_v", "n", "lo", "hi"]],
                                      other[["k1", "k2", "n_v", "n", "lo", "hi"]],
                                      check_dtype=False)
        # f32 sums round each partial to f32: rtol 1e-5, the port's groupby
        # tests' f32 tolerance
        for c in ("sum_v", "avg_v", "sum_w", "avg_w"):
            np.testing.assert_allclose(got[c], other[c], rtol=1e-5 if c.endswith("w")
                                       else 1e-12)
        for c in ("var_v", "sd_w"):
            np.testing.assert_allclose(got[c], other[c], rtol=1e-5 if c.endswith("w")
                                       else 1e-8)


@pytest.mark.parametrize("kind", ["var", "std"])
def test_chunked_var_keeps_its_digits_at_a_large_mean(chunking, kind):
    """Values near 1e6 with a spread near 1: merged sums of squares cancel
    (E[x^2] - mean^2 loses about ten digits, the reference's streaming
    groupby, pinned); merged M2 states do not. Chunked and streamed,
    against the unchunked groupby and pandas at the f64 var tolerance."""
    rng = np.random.default_rng(9)
    n = N_CHUNKED
    df = pd.DataFrame({"k": rng.integers(0, 4, n), "v": 1e6 + rng.normal(size=n)})
    t = tt.Table.from_pandas(df, device="cpu")
    aggs = [TAgg("v", kind, "out")]
    want = _unchunked(lambda: tgroupby(t, ["k"], aggs)).to_pandas()
    got = tgroupby(t, ["k"], aggs).to_pandas()
    assert chunking("groupby") == 1
    rparts, tparts = _parts(df, 7)
    streamed = tstreaming(tparts, ["k"], aggs).to_pandas()
    pandas = df.groupby("k", as_index=False).agg(out=("v", kind))
    for other in (want, pandas):
        np.testing.assert_allclose(got["out"], other["out"], rtol=_rtol(kind))
        np.testing.assert_allclose(streamed["out"], other["out"], rtol=_rtol(kind))
    ref = rstreaming(rparts, ["k"], [RAgg("v", kind, "out")]).to_pandas()
    assert not np.allclose(ref["out"], pandas["out"], rtol=_rtol(kind), atol=0)


def test_chunked_groupby_leaves_what_does_not_merge_to_one_pass(chunking):
    df = _chunk_frame()
    t = tt.Table.from_pandas(df, device="cpu")
    aggs = [TAgg("v", "median", "m")]
    got = tgroupby(t, ["k2"], aggs).to_pandas()
    assert chunking("groupby") == 0
    want = _unchunked(lambda: tgroupby(t, ["k2"], aggs)).to_pandas()
    pd.testing.assert_frame_equal(got, want)


def test_chunked_compaction_equals_unchunked_and_reference(chunking):
    df = _chunk_frame()
    t = tt.Table.from_pandas(df, device="cpu")
    r = ct.Table.from_pandas(df)
    mask = tt.Column.from_numpy(df["v"].to_numpy() > 0, device="cpu")
    rmask = ct.Column.from_numpy(df["v"].to_numpy() > 0)
    for fn, rfn in ((lambda: tsc.drop_nulls(t), lambda: rsc.drop_nulls(r)),
                    (lambda: tsc.apply_boolean_mask(t, mask),
                     lambda: rsc.apply_boolean_mask(r, rmask)),
                    (lambda: tsc.drop_nans(t, ["k1"]), None)):
        before = chunking("compaction")
        got = fn().to_pandas()
        assert chunking("compaction") == before + 1
        pd.testing.assert_frame_equal(got, _unchunked(fn).to_pandas())
        if rfn is not None:
            pd.testing.assert_frame_equal(got, rfn().to_pandas(), check_dtype=False)


def test_a_card_is_asked_only_for_large_ops(monkeypatch):
    """With no budget, a CUDA op under QUERY_SHARE of the card never
    chunks and never calls mem_get_info; a larger one gets DEVICE_SHARE of
    the free memory, plus the allocator's cached blocks when free memory
    alone falls short (the card's calls faked here, on the CPU)."""
    import torch

    calls = []
    monkeypatch.setattr(chunked, "_card_bytes", lambda index: 80 << 30)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: calls.append(1) or (40 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 30 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 10 << 30)
    card = torch.device("cuda:0")
    assert chunked.memory_limit(card, 10 << 30) is None and not calls
    assert chunked.memory_limit(card, 11 << 30) == 20 << 30 and len(calls) == 1
    assert chunked.memory_limit(card, 30 << 30) == 30 << 30
    thbm.set_hbm_budget(thbm.HbmBudget(1 << 20))
    try:
        assert chunked.memory_limit(card, 1 << 10) == 1 << 20
    finally:
        thbm.set_hbm_budget(None)


def test_an_installed_budget_drives_chunking():
    """Without CPU_LIMIT_BYTES, a budget smaller than the sort's working set
    makes it chunk; with none installed, nothing chunks."""
    df = _chunk_frame()
    t = tt.Table.from_pandas(df, device="cpu")
    before = chunked.runs["sort"]
    want = tsorting.sort_by_key(t, ["k1"]).to_pandas()
    assert chunked.runs["sort"] == before
    thbm.set_hbm_budget(thbm.HbmBudget(table_device_bytes(t)))
    try:
        got = tsorting.sort_by_key(t, ["k1"]).to_pandas()
    finally:
        thbm.set_hbm_budget(None)
    assert chunked.runs["sort"] == before + 1
    pd.testing.assert_frame_equal(got, want)
