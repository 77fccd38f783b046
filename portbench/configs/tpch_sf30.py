"""TPC-H at SF30 through the port's IR executor: q1, q3, q5 and q6.

``generate`` draws the tables on the device by the specification's rules
(``portbench.generators.tpch``; the reference is handed the same) from
the configuration's ``data_seed``: dbgen's data at a scale factor is one
fixed set. ``build`` hands them to the port through its public
constructors. Each operation plans its query with substitution
parameters that the run draws for it from its seed (``PARAMETERS``, as
qgen does), executes the plan and brings the result to the host with
``to_pandas``, as a user gets it. The plan builders are
``benchmarks/tpch.py``'s with the parameters put in for the constants.
"""
from __future__ import annotations

import numpy as np

from portbench.generators import qgen
from portbench.generators import tpch as dbgen
from portbench.generators.tpch import DICTIONARIES
from portbench.generators.qgen import PARAMETERS  # noqa: F401


def generate(spec: dict, seed: int, device) -> dict:
    """The tables: one fixed set (``data_seed``), whatever the run's seed."""
    return dbgen.generate(spec, spec["data_seed"], device)


def _column(name: str, kind: str, t: torch.Tensor):
    """A port column over ``t`` through the port's public constructors."""
    from cudf_tpu_torch import Column, dtypes
    from cudf_tpu_torch.core.interop import from_dlpack

    if kind == "string":
        c = from_dlpack(t)
        return Column(dtypes.string, c.data, None, c.length,
                      dictionary=np.array(DICTIONARIES[name]))
    if kind == "timestamp[ns]":
        return from_dlpack(t, dtypes.timestamp("ns"))
    return from_dlpack(t)


def build(raw: dict, spec: dict, operations, device) -> dict:
    """The port's tables (every table, resident for the whole run) and
    the plans of ``operations`` over them. Takes the columns out of
    ``raw`` as it goes, so the raw tensors are freed one by one."""
    from cudf_tpu_torch import Table
    from cudf_tpu_torch.expr import expressions as E
    from cudf_tpu_torch.expr import ir as IR

    tables = {}
    for t, cols in raw.items():
        kinds = spec["tables"][t]["columns"]
        tables[t] = Table({n: _column(n, kinds[n], cols.pop(n)) for n in list(cols)})

    def T(name):
        return IR.DataFrameScan(tables[name])

    return {"tables": tables, "scan": T}


def _execute(q):
    def op(state, span, params):
        from cudf_tpu_torch.expr import expressions as E
        from cudf_tpu_torch.expr import ir as IR

        plan = BUILDERS[q](state["scan"], E, IR, E.col, *params)
        return IR.execute(plan).to_pandas()

    op.__name__ = q
    return op


# ------------------------------------------------ benchmarks/tpch.py's plans
def build_q1(T, E, IR, col, delta):
    cutoff = qgen.q1_cutoff(delta)
    return IR.Sort(("l_returnflag", "l_linestatus"), (False, False), (True, True), children=(
        IR.GroupBy(
            ("l_returnflag", "l_linestatus"),
            (E.NamedExpr("sum_qty", col("l_quantity").sum()),
             E.NamedExpr("sum_base_price", col("l_extendedprice").sum()),
             E.NamedExpr("sum_disc_price", (col("l_extendedprice") * (1 - col("l_discount"))).sum()),
             E.NamedExpr("sum_charge", (col("l_extendedprice") * (1 - col("l_discount")) * (1 + col("l_tax"))).sum()),
             E.NamedExpr("avg_qty", col("l_quantity").mean()),
             E.NamedExpr("avg_price", col("l_extendedprice").mean()),
             E.NamedExpr("avg_disc", col("l_discount").mean()),
             E.NamedExpr("count_order", E.Len())),
            children=(IR.Filter(col("l_shipdate") <= E.Literal(cutoff),
                                children=(T("lineitem"),)),),
        ),))


def build_q3(T, E, IR, col, segment, day):
    cutoff = np.datetime64(day, "ns")
    return IR.Slice(0, 10, children=(
        IR.Sort(("revenue",), (True,), (True,), children=(
            IR.GroupBy(
                ("o_orderkey", "o_shippriority"),
                (E.NamedExpr("revenue", (col("l_extendedprice") * (1 - col("l_discount"))).sum()),),
                children=(
                    IR.Join(("o_orderkey",), ("l_orderkey",), "inner", children=(
                        IR.Join(("c_custkey",), ("o_custkey",), "inner", children=(
                            IR.Filter(col("c_mktsegment") == E.lit(segment),
                                      children=(T("customer"),)),
                            IR.Filter(col("o_orderdate") < E.Literal(cutoff),
                                      children=(T("orders"),)),
                        )),
                        IR.Filter(col("l_shipdate") > E.Literal(cutoff),
                                  children=(T("lineitem"),)),
                    )),
                ),),
        )),))


def build_q5(T, E, IR, col, region, year):
    lo = np.datetime64(f"{year}-01-01", "ns")
    hi = np.datetime64(f"{year + 1}-01-01", "ns")
    return IR.Sort(("revenue",), (True,), (True,), children=(
        IR.GroupBy(
            ("n_name",),
            (E.NamedExpr("revenue", (col("l_extendedprice") * (1 - col("l_discount"))).sum()),),
            children=(
                IR.Join(("s_suppkey", "s_nationkey"), ("l_suppkey", "c_nationkey"), "inner", children=(
                    IR.Join(("n_nationkey",), ("s_nationkey",), "inner", children=(
                        IR.Join(("r_regionkey",), ("n_regionkey",), "inner", children=(
                            IR.Filter(col("r_name") == E.lit(region), children=(T("region"),)),
                            T("nation"),
                        )),
                        T("supplier"),
                    )),
                    IR.HStack((E.NamedExpr("c_nationkey", col("c_nationkey")),), children=(
                        IR.Join(("o_orderkey",), ("l_orderkey",), "inner", children=(
                            IR.Join(("c_custkey",), ("o_custkey",), "inner", children=(
                                T("customer"),
                                IR.Filter((col("o_orderdate") >= E.Literal(lo)) & (col("o_orderdate") < E.Literal(hi)),
                                          children=(T("orders"),)),
                            )),
                            T("lineitem"),
                        )),
                    )),
                )),
            ),),
    ))


def build_q6(T, E, IR, col, year, discount, quantity):
    lo = np.datetime64(f"{year}-01-01", "ns")
    hi = np.datetime64(f"{year + 1}-01-01", "ns")
    return IR.GroupBy(
        (), (E.NamedExpr("revenue", (col("l_extendedprice") * col("l_discount")).sum()),),
        children=(
            IR.Filter(
                (col("l_shipdate") >= E.Literal(lo)) & (col("l_shipdate") < E.Literal(hi))
                & (col("l_discount") >= (discount - 1) / 100)
                & (col("l_discount") <= (discount + 1) / 100)
                & (col("l_quantity") < float(quantity)),
                children=(T("lineitem"),)),
        ),)


BUILDERS = {"q1": build_q1, "q3": build_q3, "q5": build_q5, "q6": build_q6}
OPERATIONS = {q: _execute(q) for q in BUILDERS}
