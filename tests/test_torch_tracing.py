"""The port's ranges (``utils/tracing.py``) on a CPU ``torch.profiler``
trace: ingest's conversion and copy, the join's hash builds and host
reads, compaction, the groupby lanes, a grouped correlation's moments and
a grouped head; that nothing changes and nothing prints with no
profiler running; and, on the card, the ``performance_tracking`` log's
``wall_s`` holding the range's device work.
"""
import contextlib
import json

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ctt
from cudf_tpu_torch import DataFrame, Table
from cudf_tpu_torch.expr import expressions as E
from cudf_tpu_torch.expr import ir as IR
from cudf_tpu_torch.kernels import hashtable as ht
from cudf_tpu_torch.ops import join as J
from cudf_tpu_torch.ops.binaryop import binary_op
from cudf_tpu_torch.utils import options as TO

CPU = [torch.profiler.ProfilerActivity.CPU]

COLUMNS = {
    "float64": lambda: [1.5, np.nan, 3.0, 4.0],
    "int64": lambda: np.array([1, 2, 3, 4], dtype=np.int64),
    "int32": lambda: np.array([5, 6, 7, 8], dtype=np.int32),
    "bool": lambda: [True, False, True, True],
    "category": lambda: pd.Categorical(["a", "b", None, "a"]),
    "datetime64[ns]": lambda: pd.to_datetime(
        ["1995-01-01", None, "1996-03-04", "1997-05-06"]).astype("datetime64[ns]"),
    "object": lambda: pd.Series(["x", None, "z", "x"], dtype=object),
    "Int64": lambda: pd.array([1, None, 3, 4], dtype="Int64"),
}

# every host_read site of ops/join.py, ops/fastjoin.py and hashtable.build_table
SITES = {"host_read.fastjoin.n_build", "host_read.fastjoin.distinct",
         "host_read.fastjoin.matched", "host_read.join.n_out", "host_read.join.n_active",
         "host_read.join.group_start", "host_read.join.left_rows",
         "host_read.join.right_rows", "host_read.join.conditional_hits",
         "host_read.hashtable.pending"}


def _traced(fn):
    """(fn(), the profiler's events with their parents)."""
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, prof.events()


def _ancestors(e) -> list:
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _named(events, name) -> list:
    return [e for e in events if e.name == name]


def _host_reads(events) -> list:
    return [e for e in events if e.name.startswith("host_read.")]


# ------------------------------------------------------------------ ingest
def test_from_pandas_opens_a_range_per_column_and_copies_inside_them():
    pdf = pd.DataFrame({k: make() for k, make in COLUMNS.items()})
    tbl, events = _traced(lambda: Table.from_pandas(pdf, device="cpu"))
    assert tbl.names == list(COLUMNS)
    assert len(_named(events, "Table.from_pandas")) == 1
    cols = [e for e in events if e.name.startswith("from_pandas.")]
    assert sorted(e.name for e in cols) == sorted(f"from_pandas.{d}" for d in pdf.dtypes)
    assert all(_ancestors(e)[0] == "Table.from_pandas" for e in cols)
    copies = _named(events, "host_to_device")
    assert copies
    for e in copies:
        up = _ancestors(e)
        assert up[0].startswith("from_pandas.") and "Table.from_pandas" in up
    for c in cols:  # each column copies inside its own range
        assert any(c.name in _ancestors(e) for e in copies), c.name


@pytest.mark.parametrize("dtype", list(COLUMNS))
def test_each_kind_of_column_names_its_range(dtype):
    pdf = pd.DataFrame({"c": COLUMNS[dtype]()})
    assert str(pdf["c"].dtype) == dtype
    _, events = _traced(lambda: Table.from_pandas(pdf, device="cpu"))
    (col,) = _named(events, f"from_pandas.{dtype}")
    assert any(col.name in _ancestors(e) for e in _named(events, "host_to_device"))


@pytest.mark.parametrize("dtype", list(COLUMNS))
def test_marked_nulls_are_read_once_a_column_inside_its_range(dtype):
    """A categorical or datetime column's null test runs on the device and
    the host reads its answer once, in ``host_read.ingest.nulls``; other
    columns read nothing."""
    pdf = pd.DataFrame({"c": COLUMNS[dtype]()})
    _, events = _traced(lambda: Table.from_pandas(pdf, device="cpu"))
    reads = _named(events, "host_read.ingest.nulls")
    assert len(reads) == (dtype in ("category", "datetime64[ns]"))
    assert all(_ancestors(e)[:2] == [f"from_pandas.{dtype}", "Table.from_pandas"]
               for e in reads)


def test_the_ingest_cells_frame_reads_its_nulls_three_times():
    """Two flags, one date and four float64 columns, as the benchmark's
    ingest builds them: three reads, none a float64 column's."""
    n = 1000
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({
        "l_returnflag": pd.Categorical.from_codes(rng.integers(0, 3, n), ["A", "N", "R"]),
        "l_linestatus": pd.Categorical.from_codes(rng.integers(0, 2, n), ["F", "O"]),
        "l_shipdate": rng.integers(0, 1 << 60, n).view("datetime64[ns]"),
        **{c: rng.random(n) for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}})
    tbl, events = _traced(lambda: ctt.from_pandas(pdf, device="cpu"))
    reads = _named(events, "host_read.ingest.nulls")
    assert sorted(_ancestors(e)[0] for e in reads) == [
        "from_pandas.category", "from_pandas.category", "from_pandas.datetime64[ns]"]
    assert all(tbl[c].column.validity is None for c in pdf.columns)
    pd.testing.assert_frame_equal(tbl.to_pandas(), pdf)


def test_every_host_array_crosses_inside_host_to_device(monkeypatch):
    """Spies on the ways a host array reaches a tensor (``torch.from_numpy``
    then ``copy_``, ``torch.as_tensor``, ``torch.tensor``): during an ingest
    of every kind of column, each host array is copied inside a
    ``host_to_device`` range, whose name the spy on ``annotate`` tracks."""
    from cudf_tpu_torch.core import column as C

    open_ranges, born, crossed = [], [], []
    real_annotate, real_from_numpy = C.annotate, torch.from_numpy
    real_copy, real_as_tensor, real_tensor = torch.Tensor.copy_, torch.as_tensor, torch.tensor

    def annotate(name, **meta):
        @contextlib.contextmanager
        def ranged():
            open_ranges.append(name)
            try:
                with real_annotate(name, **meta):
                    yield
            finally:
                open_ranges.pop()
        return ranged()

    def from_numpy(arr):
        t = real_from_numpy(arr)
        born.append(t)  # kept alive, so no later tensor reuses its address
        return t

    def copy_(self, src, *args, **kwargs):
        if any(src.data_ptr() == b.data_ptr() and src.numel() for b in born):
            crossed.append(("copy_", "host_to_device" in open_ranges))
        return real_copy(self, src, *args, **kwargs)

    def from_host(real, name):
        def spy(data, *args, **kwargs):
            if isinstance(data, np.ndarray):
                crossed.append((name, "host_to_device" in open_ranges))
            return real(data, *args, **kwargs)
        return spy

    monkeypatch.setattr(C, "annotate", annotate)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    monkeypatch.setattr(torch, "as_tensor", from_host(real_as_tensor, "as_tensor"))
    monkeypatch.setattr(torch, "tensor", from_host(real_tensor, "tensor"))
    pdf = pd.DataFrame({k: make() for k, make in COLUMNS.items()})
    pdf["timedelta64[ns]"] = pd.to_timedelta([1, None, 3, 4], unit="ns")
    tbl = Table.from_pandas(pdf, device="cpu")
    monkeypatch.undo()
    assert len(crossed) >= len(pdf.columns)
    assert all(inside for _, inside in crossed), crossed
    assert tbl.names == list(pdf.columns)


@pytest.mark.parametrize("entry", ["ctt.from_pandas", "DataFrame.from_pandas", "DataFrame"])
def test_every_public_ingest_opens_table_from_pandas(entry):
    pdf = pd.DataFrame({"a": [1.0, 2.0], "b": ["u", "v"]})
    fn = {"ctt.from_pandas": lambda: ctt.from_pandas(pdf, device="cpu"),
          "DataFrame.from_pandas": lambda: DataFrame.from_pandas(pdf, device="cpu"),
          "DataFrame": lambda: DataFrame(pdf, device="cpu")}[entry]
    df, events = _traced(fn)
    assert len(_named(events, "Table.from_pandas")) == 1
    pd.testing.assert_frame_equal(df.to_pandas(), pdf)


# ------------------------------------------------------------------- joins
def _tables(left_keys, right_keys, nullable=False):
    kind = "Int64" if nullable else "int64"
    left = pd.DataFrame({"k": pd.array(left_keys, dtype=kind),
                         "v": np.arange(len(left_keys), dtype=np.float64)})
    right = pd.DataFrame({"k": pd.array(right_keys, dtype=kind),
                          "w": np.arange(len(right_keys), dtype=np.float64) * 10})
    return (Table.from_pandas(left, device="cpu"), Table.from_pandas(right, device="cpu"),
            left, right)


def _rebuilding_key(monkeypatch) -> int:
    """A key k such that the right side {0, k} finds no slot at the first
    table size and places at the second, with one probe a row."""
    monkeypatch.setattr(ht, "MAX_PROBE", 1)
    real, placed = ht.build_table, []

    def spy(*args):
        out = real(*args)
        placed.append(out[3])
        return out

    monkeypatch.setattr(ht, "build_table", spy)
    try:
        for k in range(1, 4096):
            placed.clear()
            lt, rt, _, _ = _tables([0, k, k + 1], [0, k])
            J.join(lt, rt, ["k"], ["k"])
            if placed == [False, True]:
                return k
    finally:
        monkeypatch.setattr(ht, "build_table", real)
    raise AssertionError("no key needs a second table size")


def test_a_rebuilt_hash_table_opens_two_rounds_in_one_build(monkeypatch):
    k = _rebuilding_key(monkeypatch)
    lt, rt, left, right = _tables([0, k, k + 1], [0, k])
    out, events = _traced(lambda: J.join(lt, rt, ["k"], ["k"]))
    (build,) = _named(events, "hash_build")
    rounds = _named(events, "hash_build.round")
    assert len(rounds) == 2 and all(r.cpu_parent is build for r in rounds)
    assert "join" in _ancestors(build)
    reads = _host_reads(events)
    assert reads and all("join" in _ancestors(e) for e in reads)
    assert all(any(e.name == "host_read.hashtable.pending" and e.cpu_parent is r
                   for e in reads) for r in rounds)
    want = left.merge(right, on="k")
    assert out.to_pandas().reset_index(drop=True).equals(want)


# each case: (left keys, right keys, nullable, how, ordered) and the sites it reads
JOINS = {
    "hash_inner": (([3, 1, 2, 9], [1, 2, 3], False, "inner", True),
                   {"host_read.fastjoin.n_build", "host_read.hashtable.pending",
                    "host_read.fastjoin.distinct", "host_read.fastjoin.matched"}),
    "hash_semi": (([3, 1, 2, 9], [1, 1, 3], False, "semi", True),
                  {"host_read.fastjoin.n_build", "host_read.hashtable.pending"}),
    "general_inner": (([3, 1, 2, 9], [1, 1, 3], False, "inner", True),
                      {"host_read.fastjoin.distinct", "host_read.join.group_start",
                       "host_read.join.left_rows", "host_read.join.right_rows",
                       "host_read.join.n_out"}),
    "swap_nullable": (([1, None], [1, 2, 3, None], True, "inner", False),
                      {"host_read.join.n_active", "host_read.fastjoin.matched"}),
}


@pytest.mark.parametrize("case", list(JOINS))
def test_join_host_reads_open_inside_join(case):
    (lk, rk, nullable, how, ordered), sites = JOINS[case]
    lt, rt, left, right = _tables(lk, rk, nullable)
    out, events = _traced(lambda: J.join(lt, rt, ["k"], ["k"], how, ordered=ordered))
    reads = _host_reads(events)
    assert sites <= {e.name for e in reads}
    assert {e.name for e in reads} <= SITES
    assert all("join" in _ancestors(e) for e in reads)
    got = out.to_pandas()
    left, right = left.dropna(), right.dropna()  # a null key matches nothing (cuDF)
    if how == "semi":
        want = left[left.k.isin(right.k)]
    else:
        want = left.merge(right, on="k")
    key = list(got.columns)
    pd.testing.assert_frame_equal(  # a nullable key comes back as int64 or Int64
        got.sort_values(key).reset_index(drop=True),
        want.sort_values(key).reset_index(drop=True), check_dtype=False)


def test_conditional_join_names_its_read():
    lt, rt, _, _ = _tables([1, 2, 3], [2, 3])
    out, events = _traced(lambda: J.conditional_join(
        lt, rt, lambda p: binary_op(p["k"], p["k_y"], "lt")))
    assert {e.name for e in _host_reads(events)} == {"host_read.join.conditional_hits"}
    assert out.num_rows == 3


# -------------------------------------------------------------- compaction
def test_frame_mask_filter_and_ir_filter_each_compact_in_a_range():
    pdf = pd.DataFrame({"a": [1.0, 5.0, 3.0, 7.0], "b": [1, 2, 3, 4]})
    df = DataFrame.from_pandas(pdf, device="cpu")
    got, events = _traced(lambda: df[df["a"] > 2.0])
    assert len(_named(events, "apply_boolean_mask")) == 1
    pd.testing.assert_frame_equal(got.to_pandas(), pdf[pdf.a > 2.0])
    plan = IR.Filter(E.col("a") > 2.0, children=(IR.DataFrameScan(df._tbl),))
    got, events = _traced(lambda: IR.execute(plan))
    assert len(_named(events, "apply_boolean_mask")) == 1
    assert got.to_pandas().reset_index(drop=True).equals(
        pdf[pdf.a > 2.0].reset_index(drop=True))


# ------------------------------------------------------------ groupby lanes
LANES = ["onehot", "dense", "sort", "wide", "generic"]


def _lane_case(lane):
    """(table, keys, aggregations) that ``lane`` answers: an f32 sum at a
    few keys, an f64 sum there, an f64 min there, two int64 keys spread over
    2^62 (too wide for one word), a median."""
    from cudf_tpu_torch.ops.groupby import AggSpec

    rng = np.random.default_rng(3)
    n = 400
    pdf = pd.DataFrame({"k": rng.integers(0, 5, n),
                        "w1": rng.integers(0, 2**62, 4, dtype=np.int64)[rng.integers(0, 4, n)],
                        "w2": rng.integers(0, 2**62, 3, dtype=np.int64)[rng.integers(0, 3, n)],
                        "f": rng.normal(size=n).astype(np.float32), "v": rng.normal(size=n)})
    tbl = Table.from_pandas(pdf, device="cpu")
    kind, col = {"onehot": ("sum", "f"), "dense": ("sum", "v"), "sort": ("min", "v"),
                 "wide": ("sum", "v"), "generic": ("median", "v")}[lane]
    keys = ["w1", "w2"] if lane == "wide" else ["k"]
    return tbl, keys, [AggSpec(col, kind, "out")]


def _no_sync(monkeypatch) -> list:
    """A list that each ``torch.cuda.synchronize`` call appends to."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    return calls


@pytest.mark.parametrize("lane", LANES)
def test_a_groupby_opens_each_lane_it_tries_once(lane, monkeypatch):
    """The lane that answers and each lane before it, which refused, open
    their range once, inside ``groupby_aggregate``; no range synchronizes."""
    from cudf_tpu_torch.ops.groupby import groupby_aggregate

    tbl, keys, aggs = _lane_case(lane)
    syncs = _no_sync(monkeypatch)
    out, events = _traced(lambda: groupby_aggregate(tbl, keys, aggs))
    assert out.num_rows > 1
    tried = LANES[:LANES.index(lane) + 1]
    assert {n: len(_named(events, f"groupby.{n}")) for n in LANES} == {
        n: int(n in tried) for n in LANES}
    for n in tried:
        assert _ancestors(_named(events, f"groupby.{n}")[0])[0] == "groupby_aggregate"
    assert syncs == []


@pytest.mark.parametrize("lane", ["sort", "generic"])
def test_corr_opens_one_range_a_call_inside_its_lane(lane, monkeypatch):
    from cudf_tpu_torch.ops import sortgroup

    if lane == "generic":
        monkeypatch.setattr(sortgroup, "sort_groupby", lambda *a, **k: None)
    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"k": rng.integers(0, 4, 200), "a": rng.integers(0, 9, 200),
                        "b": rng.normal(size=200), "c": rng.normal(size=200)})
    df = DataFrame.from_pandas(pdf, device="cpu")
    syncs = _no_sync(monkeypatch)
    got, events = _traced(lambda: df.groupby("k")[["a", "b", "c"]].corr())
    (corr,) = _named(events, "groupby.corr")
    assert _ancestors(corr)[:2] == [f"groupby.{lane}", "groupby_aggregate"]
    assert syncs == [] and got.shape == (12, 3)


def test_head_opens_one_range_a_call_around_its_compaction(monkeypatch):
    pdf = pd.DataFrame({"k": [3, 1, 3, 1, 2, 3], "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
    df = DataFrame.from_pandas(pdf, device="cpu")
    syncs = _no_sync(monkeypatch)
    got, events = _traced(lambda: df.groupby("k").head(1))
    (head,) = _named(events, "groupby_head")
    (mask,) = _named(events, "apply_boolean_mask")
    assert "groupby_head" in _ancestors(mask) and not _ancestors(head)
    assert syncs == []
    pd.testing.assert_frame_equal(got.to_pandas(), pdf.groupby("k").head(1))


# ------------------------------------------------------ segment reductions
def test_segment_reduce_opens_one_range_a_call(monkeypatch):
    from cudf_tpu_torch.ops.sortprim import segment_reduce

    seg = torch.tensor([0, 0, 1, 3])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    syncs = _no_sync(monkeypatch)
    got, events = _traced(lambda: [segment_reduce(vals, seg, 4, r, 1.0)
                                   for r in ("sum", "prod", "amin")])
    assert [g.tolist() for g in got] == [[4.0, 4.0, 1.0, 5.0], [2.0, 3.0, 1.0, 4.0],
                                         [1.0, 1.0, 1.0, 1.0]]
    assert len(_named(events, "segment_reduce")) == 3
    assert syncs == []


def test_q6_through_the_frame_opens_eight_reductions(monkeypatch):
    """The db-benchmark's q6 (median and std of v3 by id4 and id5) on the
    generic engine: the groups' first rows and sizes, the median's valid
    count, then its own count and group starts, the std's count, sum and
    centered squares."""
    rng = np.random.default_rng(6)
    n = 300
    pdf = pd.DataFrame({"id4": rng.integers(1, 4, n), "id5": rng.integers(1, 5, n),
                        "v3": rng.uniform(0, 100, n).round(6)})
    df = DataFrame.from_pandas(pdf, device="cpu")
    syncs = _no_sync(monkeypatch)
    got, events = _traced(lambda: df.groupby(["id4", "id5"]).agg(
        {"v3": ["median", "std"]}))
    reductions = _named(events, "segment_reduce")
    assert len(reductions) == 8
    assert all("groupby.generic" in _ancestors(e) for e in reductions)
    assert syncs == []
    want = pdf.groupby(["id4", "id5"]).agg({"v3": ["median", "std"]})
    want.columns = ["v3_median", "v3_std"]
    pd.testing.assert_frame_equal(got.to_pandas(), want)


# ------------------------------------------------------- with no profiler
def test_without_a_profiler_results_are_unchanged_and_nothing_prints(capsys):
    pdf = pd.DataFrame({"k": [3, 1, 2, 1], "v": [1.0, 2.0, 3.0, 4.0]})
    dim = pd.DataFrame({"k": [1, 2, 3], "w": [10.0, 20.0, 30.0]})
    df = DataFrame.from_pandas(pdf, device="cpu")
    joined = df.merge(DataFrame.from_pandas(dim, device="cpu"), on="k")
    kept = joined[joined["v"] > 1.5]
    pd.testing.assert_frame_equal(
        kept.to_pandas().reset_index(drop=True),
        pdf.merge(dim, on="k").query("v > 1.5").reset_index(drop=True))
    assert capsys.readouterr() == ("", "")


# -------------------------------------------------------------- the card
@pytest.mark.cuda
def test_logged_wall_time_holds_the_device_work():
    """With ``performance_tracking`` on, a groupby's logged ``wall_s`` is at
    least its CUDA-event time. The card is kept busy first, so the start
    event runs after the host's start; the end event after the host's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the log's synchronize is of the card")
    import io
    import contextlib

    from cudf_tpu_torch.ops.groupby import AggSpec, groupby_aggregate

    n = 1 << 24
    g = torch.Generator().manual_seed(7)
    tbl = Table.from_pandas(pd.DataFrame({
        "k": torch.randint(0, 1 << 20, (n,), generator=g).numpy(),
        "v": torch.rand(n, generator=g, dtype=torch.float64).numpy()}), device="cuda")
    aggs = [AggSpec("v", "sum", "s"), AggSpec("v", "mean", "m")]
    groupby_aggregate(tbl, ["k"], aggs)  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    err = io.StringIO()
    torch.cuda._sleep(50_000_000)
    start.record()
    with contextlib.redirect_stderr(err), TO.option_context("performance_tracking", True):
        groupby_aggregate(tbl, ["k"], aggs)
    end.record()
    end.synchronize()
    rec = [json.loads(line) for line in err.getvalue().splitlines()]
    (logged,) = [r for r in rec if r["op"] == "groupby_aggregate"]
    assert logged["wall_s"] >= start.elapsed_time(end) / 1e3 > 0
