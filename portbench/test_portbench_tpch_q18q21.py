"""The per-order TPC-H cell (``tpch_sf30_q18q21.per_order``) on the CPU:
the generator's rules for the columns it adds to TPC-H's, the port
against the reference through a run at a tiny size, the control, faults
that the comparison must catch, and the reader of ``groupby.nunique``
(``nunique_share``) on hand-built traces.

The cell also joins the tests of ``test_portbench_cells.py`` that run over
every cell: its tiny size goes into ``conftest.TINY`` and its faults (the
TPC-H cells' own) into that file's ``_faults`` when this module is
collected beside them, as ``test_portbench_h2o.py`` does for its cell.
"""
import numpy as np
import pytest
import torch

from portbench import conftest, readings
from portbench.generators import tpch_orders
from portbench.generators.tpch import CURRENT_DAY, DAY_NS, START
from portbench.harness import cell, compare, manifest as mf
from portbench.harness.trace import Trace

M = mf.load()
CELL, CONFIG = "tpch_sf30_q18q21.per_order", "tpch_sf30_q18q21"
# 100,000 orders: data seed 0 leaves 3 or 4 orders past each QUANTITY of
# 312-315, so that every Q18 has rows; the other counts in the ratios of SF1
TINY = {"dbgen": {"orders": 100000, "customers": 10000, "suppliers": 666, "parts": 13333},
        "tables": {"lineitem": 400000, "orders": 100000, "customer": 10000,
                   "supplier": 666}}
SEED = 2**31 + 12345
MS = 1_000_000  # ns
SOURCE_COLUMNS = {"l_shipdate": "timestamp[ns]", "l_extendedprice": "float64",
                  "l_discount": "float64", "l_tax": "float64"}


def _register():
    conftest.TINY.setdefault(CONFIG, TINY)
    try:
        from portbench import test_portbench_cells as cells
    except ImportError:  # collected without it
        return
    shared = cells._faults
    if getattr(shared, "q18q21", False):
        return

    def faults(w):
        return shared("tpch_sf30.joins") if w == CELL else shared(w)
    faults.q18q21 = True
    cells._faults = faults


_register()


def _spec():
    return mf.resize(mf.spec(M, CONFIG), TINY)


# ------------------------------------------------------------ the generator
@pytest.fixture(scope="module")
def drawn():
    """The tiny tables, lineitem with the columns its totals come from."""
    spec = _spec()
    spec["tables"]["lineitem"]["columns"].update(SOURCE_COLUMNS)
    return mf.config_module(CONFIG).generate(spec, 1, "cpu")


def _order_of(t) -> torch.Tensor:
    return torch.searchsorted(t["orders"]["o_orderkey"], t["lineitem"]["l_orderkey"])


def _days(ns: torch.Tensor) -> torch.Tensor:
    return (ns - START) // DAY_NS


RULES = ["commit date", "receipt date", "total price", "order status", "names",
         "the data is fixed"]


@pytest.mark.parametrize("rule", RULES)
def test_the_generators_rules(drawn, rule):
    li, o = drawn["lineitem"], drawn["orders"]
    order = _order_of(drawn)
    if rule == "commit date":  # the order date + 30 .. 90 days
        d = _days(li["l_commitdate"]) - _days(o["o_orderdate"])[order]
        assert int(d.min()) == 30 and int(d.max()) == 90
    elif rule == "receipt date":  # the ship date + 1 .. 30 days; about 2/3 late
        d = _days(li["l_receiptdate"]) - _days(li["l_shipdate"])
        assert int(d.min()) == 1 and int(d.max()) == 30
        late = (li["l_receiptdate"] > li["l_commitdate"]).double().mean()
        assert 0.60 < float(late) < 0.67
    elif rule == "total price":  # dbgen's cents: each line truncated twice, summed exactly
        price = torch.round(li["l_extendedprice"] * 100).long()
        disc = torch.round(li["l_discount"] * 100).long()
        tax = torch.round(li["l_tax"] * 100).long()
        cents = price * (100 - disc) // 100 * (100 + tax) // 100
        total = torch.zeros(len(o["o_orderkey"]), dtype=torch.int64).index_add_(0, order,
                                                                                 cents)
        assert torch.equal(o["o_totalprice"], total.double() / 100)
        exact = (li["l_extendedprice"] * (1 + li["l_tax"]) * (1 - li["l_discount"]))
        sums = torch.zeros(len(total), dtype=torch.float64).index_add_(0, order, exact)
        assert float((sums - o["o_totalprice"]).abs().max()) < 0.15  # < 2.1 cents a line
    elif rule == "order status":  # F: every line shipped by CURRENTDATE; O: none; else P
        shipped = (_days(li["l_shipdate"]) <= CURRENT_DAY).long()
        n = torch.bincount(order, minlength=len(o["o_orderkey"]))
        f = torch.zeros_like(n).index_add_(0, order, shipped)
        want = torch.where(f == n, 0, torch.where(f == 0, 1, 2)).to(torch.int32)
        assert torch.equal(o["o_orderstatus"], want)
        assert bool((torch.bincount(want, minlength=3) > 0).all())
    elif rule == "names":  # key in 9 digits; the dictionary sorted, code = key - 1
        d = tpch_orders.dictionaries(_spec())
        for t, key, name, prefix in (("customer", "c_custkey", "c_name", "Customer#"),
                                     ("supplier", "s_suppkey", "s_name", "Supplier#")):
            names = d[name]
            assert list(names) == sorted(names) and len(set(names)) == len(names)
            assert names[0] == f"{prefix}000000001" and len(names[-1]) == len(prefix) + 9
            tbl = drawn[t]
            assert torch.equal(tbl[name].long(), tbl[key] - 1)
        assert list(d["o_orderstatus"]) == ["F", "O", "P"]
    else:  # one fixed set (data_seed), whatever the run's seed; parameters follow it
        cfg = mf.config_module(CONFIG)
        a, b = cfg.generate(_spec(), 1, "cpu"), cfg.generate(_spec(), 2, "cpu")
        assert all(torch.equal(a[t][c], b[t][c]) for t in a for c in a[t])
        assert {t: set(c) for t, c in a.items()} == {
            t: set(v["columns"]) for t, v in _spec()["tables"].items()}
        draws = [draw(op) for draw in (cell.parameters(cfg, s, 1) for s in (1, 2))
                 for op in ("q18", "q21") * 40]
        assert {d for d in draws if isinstance(d[0], int)} == {(q,) for q in range(312, 316)}
        assert len({d for d in draws if isinstance(d[0], str)}) > 15


# ------------------------------------------------------------------- runs
@pytest.mark.parametrize("traced", [False, True])
def test_port_equals_reference_through_a_run(traced):
    """Untraced, as long as the window lasts; traced, three blocks: each
    query three times."""
    out = cell.run(CELL, SEED, 0.5, traced, "cpu", sizes=TINY)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out
    assert out["checks"]["mismatches"]["value"] == 0
    want = {m["name"] for m in mf.metrics_of(M, mf.cell(M, CELL), traced)}
    assert set(out["metrics"]) <= want
    if traced:  # the CPU trace has the program's ranges, not the card's work
        assert out["attempted"] == 6 and "nunique_share" not in out["metrics"]


def test_control_is_not_correct():
    """Q18's o_totalprice in float32 fails the 1e-10 limit; Q21's counts
    are exact in either precision."""
    work, spec = mf.cell(M, CELL), _spec()
    for seed in (SEED, 7, 8):
        reading = readings.control_reading(work, spec, seed, "cpu")
        assert reading["max_rel_err"] > spec["checks"]["max_rel_err"], reading


def _off_by_one(fn):
    def wrapper(*a, **k):
        from cudf_tpu_torch import Column

        out = fn(*a, **k)
        return Column(out.dtype, out.data + 1, out.validity, out.length)
    return wrapper


def _semi_keeps_all(fn):
    def wrapper(left, right, left_on, right_on, how="inner", *a, **k):
        return left if how == "semi" else fn(left, right, left_on, right_on, how, *a, **k)
    return wrapper


def _faults():
    """One fault a query, each with a seed whose first execution is that
    query (a window runs at least one)."""
    import cudf_tpu_torch.expr.ir as ir
    import cudf_tpu_torch.ops.groupby as groupby

    return {"q21: each distinct count off by one": (groupby, "_nunique", _off_by_one,
                                                    2**33 + 1),
            "q18: the semi join keeps every order": (ir.join_ops, "join", _semi_keeps_all,
                                                     2**33)}


@pytest.mark.parametrize("name", list(_faults()))
def test_a_fault_in_one_query_makes_correct_false(name, monkeypatch):
    mod, attr, wrap, seed = _faults()[name]
    out = cell.run(CELL, seed, 0.3, False, "cpu", sizes=TINY)
    assert out["correct"], out["checks"]
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    out = cell.run(CELL, seed, 0.3, False, "cpu", sizes=TINY)
    assert out["correct"] is False and out["failed"] == 0, (name, out["checks"])


def test_reference_answers_dates_as_iso_strings():
    """The comparison holds a date as its ISO string: the port's datetime
    column against the reference's strings, exact, and one day off counts."""
    import pandas as pd

    ns = np.array([0, 86_400 * 10**9], dtype="datetime64[ns]")
    want = {"d": ns.astype(str)}
    assert compare.compare(pd.DataFrame({"d": ns}), want)["mismatches"] == 0
    off = ns + np.timedelta64(1, "D")
    assert compare.compare(pd.DataFrame({"d": off}), want)["mismatches"] == 2


# ---------------------------------------------------------------- reader
def _ctx(ranges=(), device=()):
    trace = Trace((0, 1000 * MS), sorted(ranges, key=lambda r: (r[1], -r[2])),
                  sorted(device, key=lambda d: d[1]))
    return cell.Context(_spec(), 0.0, trace.window_s, [], None, {}, trace)


def _read(ctx):
    return mf.metric_module("nunique_share").read(ctx)


def test_the_metric_is_the_cells_and_moves_its_p95():
    (m,) = [m for m in M["per_layer"] if m["name"] == "nunique_share"]
    assert m["workloads"] == [CELL] and m["moves"] == "query_p95_ms"
    assert m["layer"] == "Groupby dispatch" and m["source"] == "device_trace"


def test_nunique_share_none_without_the_range_a_device_or_a_trace():
    """The parent program's trace (a generic groupby whose distinct count
    opens no range, a sort launched inside it); a CPU trace with the range
    but no device operation; no trace at all."""
    sort = [("DeviceRadixSortOnesweepKernel", 100 * MS, 300 * MS, 20 * MS)]
    parent = [("groupby_aggregate", 0, 500 * MS), ("groupby.generic", 10 * MS, 490 * MS)]
    assert _read(_ctx(parent, sort)) is None
    assert _read(_ctx(parent + [("groupby.nunique", 15 * MS, 480 * MS)])) is None
    assert _read(cell.Context(_spec(), 0.0, 1.0, [], None, {}, None)) is None


def test_nunique_share_counts_device_time_launched_in_the_outermost_ranges():
    ranges = [("groupby.generic", 0, 400 * MS), ("groupby.nunique", 10 * MS, 200 * MS),
              ("groupby.nunique", 20 * MS, 30 * MS),     # nested: counted once
              ("groupby.nunique", 600 * MS, 700 * MS)]
    device = [("sort", 300 * MS, 400 * MS, 25 * MS),      # launched in the first
              ("reduce", 400 * MS, 450 * MS, 199 * MS),   # and at its end
              ("gather", 450 * MS, 500 * MS, 250 * MS),   # outside every range
              ("sort", 700 * MS, 760 * MS, 650 * MS)]     # in the second
    assert _read(_ctx(ranges, device)) == pytest.approx(100 * (100 + 50 + 60) / 1000)
