"""TPC-H Q18 and Q21 through the port's IR executor, as the benchmark runs
them (``portbench/configs/tpch_sf30_q18q21.py``), against the plain torch
reference (``portbench/reference/tpch_sf30_q18q21.py``), which works Q21
out from counts of (order, supplier) pairs and takes no distinct count.

The generator's tables at 100,000 orders (data seed 0 leaves 3 or 4
orders past each QUANTITY of 312-315) and at 20,000 (seed 1, where only
the low thresholds leave rows); then hand-made tables with the cases that
decide Q21's EXISTS and NOT EXISTS and Q18's order: an order with two
lines of one supplier (a count of lines, not of suppliers, would keep or
drop it wrongly), an order whose only other supplier's line is late, a
single-supplier order, a P order, and orders tied on total price.
"""
import numpy as np
import pytest
import torch

from portbench.harness import compare, manifest as mf
from portbench.harness.cell import quiet_span

CONFIG = "tpch_sf30_q18q21"
SIZES = {  # orders: (customers, suppliers, parts) in the specification's ratios
    100000: (10000, 666, 13333), 20000: (2000, 133, 2666)}
RUNS = [("q18", (q,)) for q in (150, 250, 312, 313, 314, 315)] + [
    ("q21", (n,)) for n in ("ALGERIA", "CHINA", "PERU", "UNITED STATES")]


def _spec(orders, data_seed):
    customers, suppliers, parts = SIZES.get(orders, (orders, orders, orders))
    spec = mf.resize(mf.spec(mf.load(), CONFIG), {
        "dbgen": {"orders": orders, "customers": customers, "suppliers": suppliers,
                  "parts": parts}})
    spec["data_seed"] = data_seed
    return spec


@pytest.fixture(scope="module")
def seeded():
    """{(orders, data seed): (the port's answers, the reference's)} of RUNS."""
    cfg, ref = mf.config_module(CONFIG), mf.reference_module(CONFIG)
    out = {}
    for orders, data_seed in ((100000, 0), (20000, 1)):
        spec = _spec(orders, data_seed)
        state = cfg.build(cfg.generate(spec, 5, "cpu"), spec, ["q18", "q21"], "cpu")
        got = {run: cfg.OPERATIONS[run[0]](state, quiet_span, run[1]) for run in RUNS}
        want = ref.answers(cfg.generate(spec, 5, "cpu"), spec, RUNS, torch.float64)
        out[(orders, data_seed)] = got, want
    return out


@pytest.mark.parametrize("run", RUNS, ids=[f"{q}-{p[0]}" for q, p in RUNS])
@pytest.mark.parametrize("data", [(100000, 0), (20000, 1)], ids=["100k-seed0", "20k-seed1"])
def test_generated_tables_equal_the_reference(seeded, data, run):
    got, want = seeded[data]
    answer, counts = want[run]
    r = compare.compare(got[run], answer)
    assert r == {"mismatches": 0, "max_rel_err": 0.0}, (run, r)
    assert len(got[run]) == len(next(iter(answer.values())))
    q, (param,) = run
    if q == "q21" or param < 300 or data == (100000, 0):
        assert len(got[run]) > 0, run  # the case has rows to compare
    if q == "q18":  # 1 to 7 lines an order: the orders by key are ~2/7 of the lines
        first = counts["groupbys"][0]
        assert first["groups"] == data[0] and first["rows"] > 3 * first["groups"]


# ------------------------------------------------------------ hand-made
# order: (custkey, status, total price, order day, [(suppkey, late, quantity)])
ORDERS = {
    1: (1, "F", 1000.0, 10, [(1, True, 50), (1, True, 50), (2, False, 50)]),
    2: (2, "F", 1000.0, 10, [(2, True, 50), (2, False, 45)]),
    3: (4, "F", 1000.0, 5, [(1, True, 48), (3, True, 48)]),
    4: (5, "F", 300.0, 3, [(3, True, 10)]),
    5: (7, "F", 2000.0, 7, [(3, True, 50), (4, False, 50)]),
    6: (8, "F", 400.0, 2, [(4, True, 1), (1, False, 1)]),
    7: (2, "P", 500.0, 1, [(2, True, 49), (1, False, 49)]),
}
SUPPLIER_NATION = {1: 0, 2: 0, 3: 0, 4: 1}  # ALGERIA, ALGERIA, ALGERIA, ARGENTINA
DAY_NS = 86_400 * 10**9


def _hand_spec():
    spec = _spec(len(ORDERS), 0)
    spec["dbgen"] = {**spec["dbgen"], "customers": 8, "suppliers": len(SUPPLIER_NATION)}
    return spec


def _hand_tables() -> dict:
    from portbench.generators.tpch_orders import NATION_NAMES, NATIONS, STATUS

    lines = [(o, s, late, q) for o, (*_, ls) in ORDERS.items() for s, late, q in ls]
    commit = torch.tensor([100] * len(lines)) * DAY_NS
    i64 = torch.int64
    return {
        "lineitem": {
            "l_orderkey": torch.tensor([o for o, *_ in lines]),
            "l_suppkey": torch.tensor([s for _, s, *_ in lines]),
            "l_quantity": torch.tensor([float(q) for *_, q in lines], dtype=torch.float64),
            "l_commitdate": commit,
            "l_receiptdate": commit + torch.tensor([1 if late else -1
                                                    for _, _, late, _ in lines]) * DAY_NS},
        "orders": {
            "o_orderkey": torch.tensor(list(ORDERS)),
            "o_custkey": torch.tensor([v[0] for v in ORDERS.values()]),
            "o_orderdate": torch.tensor([v[3] for v in ORDERS.values()]) * DAY_NS,
            "o_totalprice": torch.tensor([v[2] for v in ORDERS.values()], dtype=torch.float64),
            "o_orderstatus": torch.tensor([STATUS.index(v[1]) for v in ORDERS.values()],
                                          dtype=torch.int32)},
        "customer": {"c_custkey": torch.arange(1, 9, dtype=i64),
                     "c_name": torch.arange(8, dtype=torch.int32)},
        "supplier": {"s_suppkey": torch.tensor(list(SUPPLIER_NATION)),
                     "s_name": torch.arange(len(SUPPLIER_NATION), dtype=torch.int32),
                     "s_nationkey": torch.tensor(list(SUPPLIER_NATION.values()))},
        "nation": {"n_nationkey": torch.arange(len(NATIONS), dtype=i64),
                   "n_name": torch.tensor([NATION_NAMES.index(n) for n, _ in NATIONS],
                                          dtype=torch.int32)},
    }


HAND = {
    # Q18 past 90: order 5, then the three at 1000.00 by date (3 on day 5)
    # and by key (1, 2 on day 10), then the P order 7; 4 and 6 are below
    ("q18", (90,)): {"o_orderkey": [5, 3, 1, 2, 7],
                     "c_name": ["Customer#000000007", "Customer#000000004",
                                "Customer#000000001", "Customer#000000002",
                                "Customer#000000002"],
                     "sum_quantity": [100.0, 96.0, 150.0, 95.0, 98.0]},
    # Q21 in ALGERIA: supplier 1's two late lines of order 1 (two lines, one
    # late supplier); 3's of order 5. Order 2 has one supplier for two
    # lines, order 3 a late line of another supplier, order 4 one line,
    # order 7 is P
    ("q21", ("ALGERIA",)): {"s_name": ["Supplier#000000001", "Supplier#000000003"],
                            "numwait": [2, 1]},
    ("q21", ("ARGENTINA",)): {"s_name": ["Supplier#000000004"], "numwait": [1]},
    ("q21", ("CHINA",)): {"s_name": [], "numwait": []},
}


@pytest.mark.parametrize("run", list(HAND), ids=[f"{q}-{p[0]}" for q, p in HAND])
def test_hand_made_cases(run):
    cfg, ref = mf.config_module(CONFIG), mf.reference_module(CONFIG)
    spec = _hand_spec()
    state = cfg.build(_hand_tables(), spec, ["q18", "q21"], "cpu")
    got = cfg.OPERATIONS[run[0]](state, quiet_span, run[1])
    answer, _ = ref.answers(_hand_tables(), spec, [run], torch.float64)[run]
    assert compare.compare(got, answer) == {"mismatches": 0, "max_rel_err": 0.0}
    for column, values in HAND[run].items():
        assert got[column].tolist() == values, column
        assert np.asarray(answer[column]).tolist() == values, column
    if run[0] == "q18":
        assert got["o_totalprice"].tolist() == [2000.0, 1000.0, 1000.0, 1000.0, 500.0]
        assert got["o_orderdate"].astype("int64").tolist()[:4] == [
            d * DAY_NS for d in (7, 5, 10, 10)]
