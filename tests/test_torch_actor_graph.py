"""The port's streaming actor graph (``parallel/actor_graph.py``) against
cudf_tpu's and the in-memory executor, on ``tests/test_actor_graph.py``'s
seven cases (fan-out and the sink included) and one whose chunks come
from ``target_partition_rows`` set by ``option_context``. Keys, counts and
row order exact where the plan orders; floats at rtol 1e-12 (the merged
groupby: 1e-9)."""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR
from cudf_tpu.parallel.actor_graph import execute_streaming as rstream

import cudf_tpu_torch as tt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.parallel import actor_graph
from cudf_tpu_torch.parallel.actor_graph import execute_streaming as tstream
from cudf_tpu_torch.utils import options


@pytest.fixture(scope="module", autouse=True)
def _drop_the_reference_traces():
    """The reference's jitted ops keep a string column's dictionary from
    their first trace (pinned in test_torch_lists.py): the traces made here
    are dropped when the module ends, so no later module decodes with them."""
    yield
    import jax

    jax.clear_caches()


def _df(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 20, n), "v": rng.standard_normal(n),
                         "w": rng.integers(0, 5, n).astype(np.int64)})


def plans(IR, E, Table, kw):
    """name -> (plan, chunk_rows, sort_by)."""
    col = E.col

    def scan(df):
        return IR.DataFrameScan(Table.from_pandas(df, **kw))

    base = scan(_df(400, 5))
    return {
        "select_filter": (IR.Filter(col("v") > 0, children=(
            IR.Select((E.NamedExpr("k", col("k")), E.NamedExpr("v", col("v")),
                       E.NamedExpr("vw", col("v") * 2)), children=(scan(_df()),)),)),
            100, None),
        "groupby": (IR.GroupBy(("k",), (E.NamedExpr("s", col("v").sum()),
                                        E.NamedExpr("m", col("v").mean()),
                                        E.NamedExpr("n", E.Len())),
                               children=(scan(_df()),)), 100, ["k"]),
        "join_broadcast": (IR.Join(("k",), ("k",), "inner", False, ("_x", "_y"), children=(
            scan(_df(800, 1)), scan(pd.DataFrame({"k": np.arange(20),
                                                   "name": [f"g{i}" for i in range(20)]})))),
            100, ["k", "v"]),
        "sort_slice": (IR.Slice(5, 50, children=(
            IR.Sort(("v",), (False,), (True,), children=(scan(_df(300, 2)),)),)), 64, None),
        "distinct_union": (IR.Distinct(("k",), "first", children=(
            IR.Union(children=(scan(_df(200, 3)), scan(_df(200, 4)))),)), 64, ["k"]),
        "fanout": (IR.Join(("k",), ("k",), "inner", False, ("_x", "_y"), children=(
            IR.GroupBy(("k",), (E.NamedExpr("s", col("v").sum()),), children=(base,)),
            IR.GroupBy(("k",), (E.NamedExpr("n", E.Len()),), children=(base,)))), 100, ["k"]),
        "var_by_option": (IR.GroupBy(("k",), (E.NamedExpr("var", col("v").var()),
                                              E.NamedExpr("n", E.Len())),
                                     children=(scan(_df(3000, 7)),)), None, ["k"]),
    }


CASES = list(plans(TIR, TE, tt.Table, {"device": "cpu"}))


def _frame(tbl, sort_by):
    df = tbl.to_pandas()
    return df.sort_values(sort_by).reset_index(drop=True) if sort_by else df


@pytest.mark.parametrize("name", CASES)
def test_streaming_equals_the_reference_and_execute(name):
    plan, rows, sort_by = plans(TIR, TE, tt.Table, {"device": "cpu"})[name]
    rplan = plans(RIR, RE, ct.Table, {})[name][0]
    with options.option_context("target_partition_rows", 700):
        got = _frame(tstream(plan, chunk_rows=rows), sort_by)
        if rows is None:
            assert actor_graph.ActorGraphExecutor().chunk_rows == 700
    want = _frame(TIR.execute(plan), sort_by)
    ref = _frame(rstream(rplan, chunk_rows=rows or 700), sort_by)
    if name == "distinct_union":
        # keep="first" across chunk boundaries keeps the key set
        got, want, ref = got[["k"]], want[["k"]], ref[["k"]]
    rtol = 1e-9 if name in ("groupby", "fanout", "var_by_option") else 1e-12
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=rtol)
    pd.testing.assert_frame_equal(got, ref, check_dtype=False, rtol=rtol)


def test_sink_writes_every_chunk(tmp_path):
    df = _df(150, 6)
    out = str(tmp_path / "o.parquet")
    plan = TIR.Sink("parquet", out, children=(
        TIR.DataFrameScan(tt.Table.from_pandas(df, device="cpu")),))
    got = tstream(plan, chunk_rows=50)
    back = pd.read_parquet(out)
    assert len(back) == got.num_rows == 150
    pd.testing.assert_frame_equal(back, df, check_dtype=False)
    rout = str(tmp_path / "r.parquet")
    rstream(RIR.Sink("parquet", rout, children=(RIR.DataFrameScan(ct.Table.from_pandas(df)),)),
            chunk_rows=50)
    pd.testing.assert_frame_equal(back, pd.read_parquet(rout), check_dtype=False)
