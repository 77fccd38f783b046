"""TPC-H at SF30 through the port's IR executor: Q18 and Q21, the queries
whose work is per order, over every order of the 180M-row lineitem.

``generate`` draws the tables on the device by the specification's rules
(``portbench.generators.tpch_orders``; the reference is handed the same)
from the configuration's ``data_seed``: dbgen's data at a scale factor is
one fixed set. ``build`` hands them to the port through its public
constructors. Each operation plans its query with the substitution
parameter that the run draws for it from its seed (``PARAMETERS``, as
qgen does), executes the plan and brings the result to the host with
``to_pandas``, as a user gets it.

- Q18: the orders whose lines' quantities sum past QUANTITY (a groupby of
  lineitem by order key, 45M groups at SF30, and its HAVING), those
  orders by a semi join, joined with their lines and their customer, a
  groupby by five keys, the largest 100 by total price.
- Q21: EXISTS and NOT EXISTS as two per-order distinct counts of the
  supplier, over every line and over the late lines (the configuration's
  ``assumed`` proves the form exact), the late lines of one nation's
  suppliers in F orders joined with both, counted by supplier name.
"""
from __future__ import annotations

from portbench.generators import tpch_orders as dbgen
from portbench.generators.tpch_orders import NATION_NAMES


def q18_parameters(rng) -> tuple:
    """(QUANTITY,): 312 to 315 (section 2.4.18.3)."""
    return (int(rng.integers(312, 316)),)


def q21_parameters(rng) -> tuple:
    """(NATION,): one of the 25 N_NAMEs (section 2.4.21.3)."""
    return (NATION_NAMES[int(rng.integers(len(NATION_NAMES)))],)


PARAMETERS = {"q18": q18_parameters, "q21": q21_parameters}


def generate(spec: dict, seed: int, device) -> dict:
    """The tables: one fixed set (``data_seed``), whatever the run's seed."""
    return dbgen.generate(spec, spec["data_seed"], device)


def build(raw: dict, spec: dict, operations, device) -> dict:
    """The port's tables (every table, resident for the whole run). Takes
    the columns out of ``raw`` as it goes, so the raw tensors are freed
    one by one."""
    from cudf_tpu_torch import Column, Table, dtypes
    from cudf_tpu_torch.core.interop import from_dlpack

    dictionaries = dbgen.dictionaries(spec)

    def column(name, kind, t):
        if kind == "string":
            c = from_dlpack(t)
            return Column(dtypes.string, c.data, None, c.length,
                          dictionary=dictionaries[name])
        if kind == "timestamp[ns]":
            return from_dlpack(t, dtypes.timestamp("ns"))
        return from_dlpack(t)

    tables = {}
    for t, cols in raw.items():
        kinds = spec["tables"][t]["columns"]
        tables[t] = Table({n: column(n, kinds[n], cols.pop(n)) for n in list(cols)})
    return {"tables": tables}


def build_q18(T, E, IR, col, quantity):
    big = IR.Filter(col("sum_qty") > float(quantity), children=(
        IR.GroupBy(("l_orderkey",), (E.NamedExpr("sum_qty", col("l_quantity").sum()),),
                   children=(T("lineitem"),)),))
    chosen = IR.Join(("o_orderkey",), ("l_orderkey",), "semi", children=(T("orders"), big))
    lines = IR.Join(("o_orderkey",), ("l_orderkey",), "inner", children=(chosen, T("lineitem")))
    rows = IR.Join(("o_custkey",), ("c_custkey",), "inner", children=(lines, T("customer")))
    keys = ("c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice")
    return IR.Slice(0, 100, children=(
        IR.Sort(("o_totalprice", "o_orderdate", "o_orderkey"), (True, False, False),
                (True, True, True), children=(
            IR.GroupBy(keys, (E.NamedExpr("sum_quantity", col("l_quantity").sum()),),
                       children=(rows,)),)),))


def build_q21(T, E, IR, col, nation):
    late = IR.Cache(0, children=(
        IR.Filter(col("l_receiptdate") > col("l_commitdate"), children=(T("lineitem"),)),))

    def suppliers(name, lines):
        return IR.GroupBy(("l_orderkey",), (E.NamedExpr(name, col("l_suppkey").nunique()),),
                          children=(lines,))

    many = IR.Filter(col("n_supp") > 1, children=(suppliers("n_supp", T("lineitem")),))
    one_late = IR.Filter(col("n_late") == 1, children=(suppliers("n_late", late),))
    theirs = IR.Join(("n_nationkey",), ("s_nationkey",), "inner", children=(
        IR.Filter(col("n_name") == E.lit(nation), children=(T("nation"),)), T("supplier")))
    l1 = IR.Join(("s_suppkey",), ("l_suppkey",), "inner", children=(theirs, late))
    l1 = IR.Join(("l_orderkey",), ("o_orderkey",), "inner", children=(
        l1, IR.Filter(col("o_orderstatus") == E.lit("F"), children=(T("orders"),))))
    l1 = IR.Join(("l_orderkey",), ("l_orderkey",), "inner", children=(l1, many))
    l1 = IR.Join(("l_orderkey",), ("l_orderkey",), "inner", children=(l1, one_late))
    return IR.Slice(0, 100, children=(
        IR.Sort(("numwait", "s_name"), (True, False), (True, True), children=(
            IR.GroupBy(("s_name",), (E.NamedExpr("numwait", E.Len()),), children=(l1,)),)),))


BUILDERS = {"q18": build_q18, "q21": build_q21}


def _execute(q):
    def op(state, span, params):
        from cudf_tpu_torch.expr import expressions as E
        from cudf_tpu_torch.expr import ir as IR

        def scan(name):
            return IR.DataFrameScan(state["tables"][name])

        plan = BUILDERS[q](scan, E, IR, E.col, *params)
        return IR.execute(plan).to_pandas()

    op.__name__ = q
    return op


OPERATIONS = {q: _execute(q) for q in BUILDERS}
