"""The port's ranges (``utils/tracing.py``) on a CPU ``torch.profiler``
trace: ingest's conversion and copy, the join's hash builds and host
reads, compaction; that nothing changes and nothing prints with no
profiler running; and, on the card, the ``performance_tracking`` log's
``wall_s`` holding the range's device work.
"""
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
