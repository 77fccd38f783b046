"""Plan lowering (``expr/lowering.py``) and the partitioned executor
(``parallel/plan_executor.py``) against cudf_tpu's.

* The lowered plans equal the reference's for the same plan, data and
  config (node types, Shuffle keys and counts, Repartitions, PartitionInfo
  of every node), except a keyless GroupBy over several partitions, which
  gets a Repartition(1) here (a reference fault, pinned below).
* ``execute_partitioned`` gives ``IR.execute``'s answer on
  ``tests/test_lowering.py``'s plan and on ``benchmarks/tpch.py``'s q1, q3,
  q5 and q6 at ``gen_tables(4000)`` under a config that splits lineitem into
  four partitions and gives q3 and q5 both a broadcast and a shuffle join:
  row order exact where the plan sorts, keys and counts exact, f64
  aggregates rtol 1e-9.
* Reference faults pinned, each where the port equals the in-memory answer
  and the reference does not: q3's top 10 and q5's order (its partitioned
  Sort ignores ``descending``), q6's one row (its keyless GroupBy runs per
  partition), and a shuffle join whose Shuffle leaves a bucket empty (it
  drops empty buckets and asserts), and shuffle joins on a string key
  whose two tables' dictionaries differ and on a key with a validity mask
  on one side only (it hashes codes and mask presence, and loses matches).
* ``partition_ids`` is bit-equal to the reference's.
"""
import importlib.util
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR
from cudf_tpu.expr.lowering import LoweringConfig as RConfig
from cudf_tpu.expr.lowering import lower_ir_graph as rlower
from cudf_tpu.ops import hashing as rhash
from cudf_tpu.parallel.plan_executor import execute_partitioned as rexecute

import cudf_tpu_torch as tt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.expr.lowering import LoweringConfig, lower_ir_graph
from cudf_tpu_torch.expr.nodebase import traversal
from cudf_tpu_torch.ops import hashing as thash
from cudf_tpu_torch.parallel import plan_executor as tpe

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("tpch_bench", ROOT / "benchmarks" / "tpch.py")
tpch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpch)

SMALL = (20_000, 2_000)
# gen_tables(4000): lineitem 256 KB in four partitions; orders (32 KB) and
# the small tables under the broadcast limit
TPCH = (64_000, 40_000)


def _df(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 50, n), "g": rng.integers(0, 7, n),
                         "v": rng.normal(size=n), "w": rng.uniform(1, 2, n)})


class Pkg:
    """One package's IR, expressions, tables and lowering, so that each
    plan builder runs on both."""

    def __init__(self, port: bool):
        self.port = port
        self.IR, self.E = (TIR, TE) if port else (RIR, RE)
        self.lower = lower_ir_graph if port else rlower
        self.Config = LoweringConfig if port else RConfig

    def table(self, df):
        return tt.Table.from_pandas(df, device="cpu") if self.port else ct.Table.from_pandas(df)

    def scan(self, df):
        return self.IR.DataFrameScan(self.table(df))


PORT, REF = Pkg(True), Pkg(False)


def _sig(root, info):
    """The lowered plan as nested tuples: each node's type, the args of
    Shuffle and Repartition, and its PartitionInfo."""
    def walk(n):
        args = n.args if type(n).__name__ in ("Shuffle", "Repartition") else ()
        pi = info[n]
        return (type(n).__name__, args, pi.count, tuple(pi.partitioned_on),
                tuple(walk(c) for c in n.children))
    return walk(root)


def _groupby(P, df):
    E = P.E
    return P.IR.GroupBy(("k",), (E.NamedExpr("s", E.Agg("sum", children=(E.col("v"),))),),
                        children=(P.scan(df),))


def _bcast_join(P, df):
    small = pd.DataFrame({"k": np.arange(50), "t": np.arange(50) * 2.0})
    return P.IR.Join(("k",), ("k",), "inner", children=(P.scan(df), P.scan(small)))


def _shuffle_join(P, df):
    return P.IR.Join(("k",), ("k",), "inner",
                     children=(P.scan(df), P.scan(_df(4000, 2))))


def _q(P, df, dim=None):
    """filter -> join -> groupby -> sort (tests/test_lowering.py's _q)."""
    E, IR = P.E, P.IR
    dim = pd.DataFrame({"k": np.arange(50), "t": np.arange(50) * 1.5}) if dim is None else dim
    filt = IR.Filter(E.col("v") > E.lit(0.0), children=(P.scan(df),))
    join = IR.Join(("k",), ("k",), "inner", children=(filt, P.scan(dim)))
    gb = IR.GroupBy(("g",), (E.NamedExpr("s", E.Agg("sum", children=(E.col("w"),))),
                             E.NamedExpr("m", E.Agg("mean", children=(E.col("v"),)))),
                    children=(join,))
    return IR.Sort(("g",), (False,), (True,), children=(gb,))


SHAPES = {"groupby": (_groupby, SMALL), "bcast_join": (_bcast_join, SMALL),
          "shuffle_join": (_shuffle_join, (20_000, 10)), "q": (_q, SMALL)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_lowered_plan_equals_the_reference(name):
    build, cfg = SHAPES[name]
    df = _df(6000, 3)
    got = PORT.lower(build(PORT, df), PORT.Config(*cfg))
    ref = REF.lower(build(REF, df), REF.Config(*cfg))
    assert _sig(*got) == _sig(*ref)
    assert got[1][got[0]].count > 1 or name == "q"


@pytest.fixture(scope="module")
def tpch_data():
    host = tpch.gen_tables(4000)
    return host, {k: PORT.table(v) for k, v in host.items()}, \
        {k: REF.table(v) for k, v in host.items()}


def _tpch_plan(q, P, tables):
    return tpch.QUERIES[q][0](lambda n: P.IR.DataFrameScan(tables[n]), P.E, P.IR, P.E.col)


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6"])
def test_lowered_tpch_plan_equals_the_reference(tpch_data, q):
    """The same lowered plan, but for q6's keyless GroupBy: the port puts a
    Repartition(1) under it where the reference lowers it partition-wise."""
    _, port, ref = tpch_data
    got, ginfo = PORT.lower(_tpch_plan(q, PORT, port), PORT.Config(*TPCH))
    want, rinfo = REF.lower(_tpch_plan(q, REF, ref), REF.Config(*TPCH))
    if q != "q6":
        assert _sig(got, ginfo) == _sig(want, rinfo)
        return
    assert type(got).__name__ == type(want).__name__ == "GroupBy"
    rep = got.children[0]
    assert type(rep).__name__ == "Repartition" and rep.args == (1,) and ginfo[got].count == 1
    assert _sig(rep.children[0], ginfo) == _sig(want.children[0], rinfo)
    assert rinfo[want].count == 4


def test_tpch_config_partitions_lineitem_and_both_join_kinds(tpch_data):
    _, port, _ = tpch_data
    for q in ("q3", "q5"):
        lowered, info = PORT.lower(_tpch_plan(q, PORT, port), PORT.Config(*TPCH))
        joins = [n for n in traversal(lowered) if type(n).__name__ == "Join"]
        shuffled = [all(type(c).__name__ == "Shuffle" for c in j.children) for j in joins]
        assert any(shuffled) and not all(shuffled), q
        scans = [n for n in traversal(lowered) if type(n).__name__ == "DataFrameScan"
                 and n._tbl is port["lineitem"]]
        assert scans and all(info[s].count >= 4 for s in scans)


@pytest.fixture(scope="module")
def tpch_answers(tpch_data):
    """Each query's port plan, in-memory answer and partitioned answer."""
    _, port, _ = tpch_data
    out = {}
    for q in ("q1", "q3", "q5", "q6"):
        plan = _tpch_plan(q, PORT, port)
        out[q] = (TIR.execute(plan).to_pandas(),
                  tpe.execute_partitioned(plan, LoweringConfig(*TPCH), device="cpu")
                  .to_pandas())
    return out


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6"])
def test_execute_partitioned_tpch_equals_in_memory(tpch_answers, tpch_data, q):
    want, got = tpch_answers[q]
    pd.testing.assert_frame_equal(got, want, rtol=1e-9)
    host = tpch_data[0]
    pd.testing.assert_frame_equal(got, tpch.QUERIES[q][1](host), rtol=1e-6, check_dtype=False)


@pytest.mark.parametrize("q", ["q3", "q5"])
def test_reference_partitioned_sort_ignores_descending(tpch_answers, tpch_data, q):
    """q3's top 10 and q5's revenue order come out of the reference's
    partitioned Sort in ascending bucket order."""
    _, _, ref = tpch_data
    want, got = tpch_answers[q]
    pd.testing.assert_frame_equal(got, want, rtol=1e-9)
    bad = rexecute(_tpch_plan(q, REF, ref), RConfig(*TPCH)).to_pandas()
    assert len(bad) == len(want)
    assert not np.allclose(bad["revenue"].to_numpy(), want["revenue"].to_numpy())
    assert (np.diff(got["revenue"].to_numpy()) <= 0).all()


def test_reference_keyless_groupby_gives_a_row_a_partition(tpch_answers, tpch_data):
    _, _, ref = tpch_data
    want, got = tpch_answers["q6"]
    assert len(got) == len(want) == 1
    assert len(rexecute(_tpch_plan("q6", REF, ref), RConfig(*TPCH)).to_pandas()) == 4


def test_shuffle_with_an_empty_bucket_keeps_the_join_aligned():
    """A left side of one key hashes into one bucket: the reference's
    Shuffle drops the empty ones and its join asserts; here each side has
    the Shuffle's count of partitions and the join equals IR.execute."""
    rng = np.random.default_rng(6)
    left = pd.DataFrame({"k": np.zeros(1000, np.int64), "a": rng.normal(size=1000)})
    right = pd.DataFrame({"k": rng.integers(0, 100, 1000), "b": rng.normal(size=1000)})
    cfg = (8_000, 10)

    def plan(P):
        return P.IR.Join(("k",), ("k",), "inner", children=(P.scan(left), P.scan(right)))

    parts = tpe.execute_partitioned(plan(PORT), LoweringConfig(*cfg), collect=False,
                                    device="cpu")
    lowered, info = lower_ir_graph(plan(PORT), LoweringConfig(*cfg))
    assert len(parts) == info[lowered].count > 1
    assert min(p.num_rows for p in parts) == 0
    got = tpe.execute_partitioned(plan(PORT), LoweringConfig(*cfg), device="cpu").to_pandas()
    want = TIR.execute(plan(PORT)).to_pandas()
    cols = list(want.columns)
    pd.testing.assert_frame_equal(got.sort_values(cols).reset_index(drop=True),
                                  want.sort_values(cols).reset_index(drop=True))
    with pytest.raises(AssertionError, match="co-partitioned"):
        rexecute(plan(REF), RConfig(*cfg))


def _keyed_sides(kind, seed=11):
    """Two tables joined on ``k``: strings whose two dictionaries differ
    (one string, two codes), or an Int64 key with nulls on the left against
    a plain int64 key on the right (a validity mask on one side only)."""
    rng = np.random.default_rng(seed)
    n, m = 3000, 2000
    if kind == "string":
        words = np.array([f"r{i:03d}" for i in range(120)])
        return (pd.DataFrame({"k": words[rng.integers(0, 90, n)], "a": rng.normal(size=n)}),
                pd.DataFrame({"k": words[rng.integers(30, 120, m)], "b": rng.normal(size=m)}))
    k = pd.array(rng.integers(0, 200, n), dtype="Int64")
    k[rng.random(n) < 0.1] = pd.NA
    return (pd.DataFrame({"k": k, "a": rng.normal(size=n)}),
            pd.DataFrame({"k": rng.integers(0, 200, m), "b": rng.normal(size=m)}))


@pytest.mark.parametrize("kind", ["string", "nullable"])
def test_shuffle_join_on_keys_that_differ_in_encoding(kind):
    """Both sides shuffle (a shuffle join), so one key value must land in
    one bucket on both: the port equals IR.execute and pandas; the
    reference hashes a string's dictionary code and a mask's presence, and
    loses matches (pinned)."""
    left, right = _keyed_sides(kind)
    cfg = (20_000, 10)

    def plan(P):
        return P.IR.Join(("k",), ("k",), "inner", children=(P.scan(left), P.scan(right)))

    lowered, info = lower_ir_graph(plan(PORT), LoweringConfig(*cfg))
    assert [type(c).__name__ for c in lowered.children] == ["Shuffle", "Shuffle"]
    assert info[lowered].count > 1
    got = tpe.execute_partitioned(plan(PORT), LoweringConfig(*cfg), device="cpu").to_pandas()
    want = TIR.execute(plan(PORT)).to_pandas()
    cols = list(want.columns)
    pd.testing.assert_frame_equal(got.sort_values(cols).reset_index(drop=True),
                                  want.sort_values(cols).reset_index(drop=True))
    pandas = left.merge(right, on="k")[cols].sort_values(cols).reset_index(drop=True)
    pd.testing.assert_frame_equal(got.sort_values(cols).reset_index(drop=True), pandas,
                                  check_dtype=False)
    assert len(rexecute(plan(REF), RConfig(*cfg)).to_pandas()) < len(want)


def test_execute_partitioned_q_plan(tmp_path):
    df = _df(6000, 3)
    dim = pd.DataFrame({"k": np.arange(50), "t": np.arange(50) * 1.5})
    got = tpe.execute_partitioned(_q(PORT, df, dim), LoweringConfig(*SMALL),
                                  device="cpu").to_pandas()
    want = (df[df["v"] > 0.0].merge(dim, on="k").groupby("g", as_index=False)
            .agg(s=("w", "sum"), m=("v", "mean")).sort_values("g").reset_index(drop=True))
    pd.testing.assert_frame_equal(got, TIR.execute(_q(PORT, df, dim)).to_pandas(), rtol=1e-9)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    # the shuffle join, and a groupby over a parquet Scan
    other = _df(6000, 4)[["k", "w"]].rename(columns={"w": "w2"})
    join = TIR.Join(("k",), ("k",), "inner", children=(PORT.scan(df), PORT.scan(other)))
    got = tpe.execute_partitioned(join, LoweringConfig(30_000, 10), device="cpu").to_pandas()
    cols = list(got.columns)
    pd.testing.assert_frame_equal(got.sort_values(cols).reset_index(drop=True),
                                  df.merge(other, on="k")[cols].sort_values(cols)
                                  .reset_index(drop=True), check_dtype=False)
    p = str(tmp_path / "d.parquet")
    df.to_parquet(p)
    scan = TIR.GroupBy(("g",), (TE.NamedExpr("s", TE.Agg("sum", children=(TE.col("v"),))),),
                       children=(TIR.Scan("parquet", (p,), device="cpu"),))
    lowered, info = lower_ir_graph(scan, LoweringConfig(20_000, 10))
    assert info[lowered.children[0].children[0]].count > 1
    got = tpe.execute_partitioned(scan, LoweringConfig(20_000, 10), device="cpu").to_pandas()
    pd.testing.assert_frame_equal(got.sort_values("g").reset_index(drop=True),
                                  TIR.execute(scan).to_pandas(), rtol=1e-12)


def test_execute_partitioned_defaults_to_cuda():
    plan = TIR.DataFrameScan(tt.Table.from_pandas(pd.DataFrame({"a": [1]}), device="cpu"))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpe.execute_partitioned(plan)


def test_execute_spmd_names_its_roadmap_item():
    """The distributed item has landed: ``execute_spmd`` runs. Without a
    mesh it takes every CUDA device, and asks for one like every entry
    point; on a CPU mesh it gives the plan's answer
    (``tests/test_torch_spmd.py`` holds it against the reference)."""
    from cudf_tpu_torch.parallel import spmd

    plan = TIR.DataFrameScan(tt.Table.from_pandas(pd.DataFrame({"a": [1]}), device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpe.execute_spmd(plan)
    out = tpe.execute_spmd(plan, mesh=spmd.make_mesh(2, devices=["cpu"]))
    assert out.to_pandas()["a"].tolist() == [1]


def _hash_frame():
    rng = np.random.default_rng(7)
    n = 3000
    f = rng.normal(size=n)
    f[::17] = np.nan
    f[::23] = -0.0
    i = pd.array(rng.integers(-5, 5, n), dtype="Int64")
    i[::11] = pd.NA
    return pd.DataFrame({"i": i, "f": f, "s": rng.choice(["x", "yy", "zzz"], n),
                         "u": rng.integers(0, 2**31, n).astype(np.int32)})


@pytest.mark.parametrize("cols", [["i"], ["f"], ["s"], ["u"], ["i", "f", "s"]])
@pytest.mark.parametrize("n_parts", [1, 3, 4, 7, 256])
def test_partition_ids_bit_equal_to_reference(cols, n_parts):
    df = _hash_frame()
    t, r = PORT.table(df), REF.table(df)
    got = thash.partition_ids([t[c] for c in cols], n_parts)
    ref = np.asarray(rhash.partition_ids([r[c] for c in cols], n_parts))
    n = len(df)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[:n].numpy(), ref[:n])
    assert got[:n].min() >= 0 and got[:n].max() < n_parts
