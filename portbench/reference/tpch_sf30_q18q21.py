"""TPC-H Q18 and Q21 in plain torch, from the generated tables, for a set
of substitution parameters, worked out from the specification's text.

- Q18: each order's quantity summed by ``index_add_`` into float64 over a
  dense order index (``plain.lookup`` of the line's order key among the
  order keys), the orders past QUANTITY with their customer, sorted by
  total price descending, order date and order key (the configuration's
  ``assumed``), the first 100.
- Q21: the EXISTS and NOT EXISTS of the query as counts of (order,
  supplier) pairs and takes no distinct count: a late line l1 of order o
  with supplier s is kept where ``lines(o) - lines(o, s) > 0`` (another
  supplier's line exists) and ``late(o) - late(o, s) == 0`` (no late line
  of another supplier), and where s is of NATION and o's status is F;
  the lines kept are counted by supplier name, sorted by the count
  descending and the name, the first 100.

The values are rounded to ``dtype`` and each row's arithmetic is done in
it; every sum accumulates in float64 (the control rounds the values to
float32 and keeps that accumulator). A date answers as its ISO string
(``numpy.datetime64`` in ns as ``str``), which the comparison holds
exactly as it holds strings. Besides the answer, each query reports what
its keyed groupbys see (rows, keys, columns read, groups), which
``groupby_roofline`` counts bytes from.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.generators.tpch_orders import NATION_NAMES, STATUS, dictionaries
from portbench.reference.plain import lookup

ACC = torch.float64


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _dates(ns: torch.Tensor) -> np.ndarray:
    return _host(ns).view("datetime64[ns]").astype(str)


def _groupby(rows, keys, reads, groups, out) -> dict:
    return {"rows": int(rows), "keys": keys, "reads": reads, "groups": int(groups),
            "out": out}


def _names(spec, shared, column) -> np.ndarray:
    if "names" not in shared:
        shared["names"] = dictionaries(spec)
    return shared["names"][column]


def _per_order(t, dtype, shared) -> tuple:
    """(each line's order index, each order's quantity in float64), once a
    set of answers."""
    if "q18" not in shared:
        li, o = t["lineitem"], t["orders"]
        order = lookup([o["o_orderkey"]], [li["l_orderkey"]])
        qty = li["l_quantity"].to(dtype).to(ACC)
        sums = torch.zeros(len(o["o_orderkey"]), dtype=ACC, device=qty.device)
        shared["q18"] = order, sums.index_add_(0, order, qty)
    return shared["q18"]


def q18(t, spec, dtype, shared, quantity):
    o, c = t["orders"], t["customer"]
    order, sums = _per_order(t, dtype, shared)
    big = torch.nonzero(sums > quantity).squeeze(1)
    cust = lookup([c["c_custkey"]], [o["o_custkey"][big]])
    price = _host(o["o_totalprice"][big].to(dtype).to(ACC))
    day = _host(o["o_orderdate"][big])
    key = _host(o["o_orderkey"][big])
    first = np.lexsort((key, day, -price))[:100]
    answer = {"c_name": _names(spec, shared, "c_name")[_host(c["c_name"][cust])[first]],
              "c_custkey": _host(c["c_custkey"][cust])[first],
              "o_orderkey": key[first],
              "o_orderdate": _dates(o["o_orderdate"][big])[first],
              "o_totalprice": price[first],
              "sum_quantity": _host(sums[big])[first]}
    groups = int(torch.count_nonzero(torch.bincount(order)))
    counts = {"joins": [], "groupbys": [
        _groupby(len(order), ["l_orderkey"], ["l_quantity"], groups, ["float64"]),
        _groupby(int(torch.isin(order, big).sum()),
                 ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"],
                 ["l_quantity"], len(big), ["float64"])]}
    return answer, counts


def _waiting(t, shared) -> tuple:
    """(each line's supplier index, whether it is an l1 of Q21 but for
    NATION, the groupbys' counts), once a set of answers: a late line of
    an F order, of whose order another supplier has a line and no other
    supplier a late line."""
    if "q21" not in shared:
        li, o, s = t["lineitem"], t["orders"], t["supplier"]
        n_ord, n_supp = len(o["o_orderkey"]), len(s["s_suppkey"])
        order = lookup([o["o_orderkey"]], [li["l_orderkey"]])
        supp = lookup([s["s_suppkey"]], [li["l_suppkey"]])
        late = li["l_receiptdate"] > li["l_commitdate"]
        pairs, pair = torch.unique(order * n_supp + supp, return_inverse=True)
        lines_o = torch.bincount(order, minlength=n_ord)
        late_o = torch.bincount(order[late], minlength=n_ord)
        lines_os = torch.bincount(pair, minlength=len(pairs))
        late_os = torch.bincount(pair[late], minlength=len(pairs))
        exists = lines_o[order] - lines_os[pair] > 0
        not_exists = late_o[order] - late_os[pair] == 0
        finished = o["o_orderstatus"][order] == STATUS.index("F")
        groupbys = [
            _groupby(len(order), ["l_orderkey"], ["l_suppkey"],
                     torch.count_nonzero(lines_o), ["int64"]),
            _groupby(int(late.sum()), ["l_orderkey"], ["l_suppkey"],
                     torch.count_nonzero(late_o), ["int64"])]
        shared["q21"] = supp, late & finished & exists & not_exists, groupbys
    return shared["q21"]


def q21(t, spec, dtype, shared, nation):
    s, n = t["supplier"], t["nation"]
    supp, waited, groupbys = _waiting(t, shared)
    nation_key = n["n_nationkey"][n["n_name"] == NATION_NAMES.index(nation)]
    l1 = waited & (s["s_nationkey"][supp] == nation_key)
    numwait = torch.bincount(supp[l1], minlength=len(s["s_suppkey"]))
    waiting = torch.nonzero(numwait).squeeze(1)
    count, code = _host(numwait[waiting]), _host(s["s_name"][waiting])
    first = np.lexsort((code, -count))[:100]
    answer = {"s_name": _names(spec, shared, "s_name")[code[first]], "numwait": count[first]}
    counts = {"joins": [], "groupbys": groupbys + [
        _groupby(int(l1.sum()), ["s_name"], [], len(waiting), ["int64"])]}
    return answer, counts


QUERIES = {"q18": q18, "q21": q21}


def answers(raw: dict, spec: dict, instances, dtype) -> dict:
    """{(operation, parameters): (answer: {column: ndarray}, counts)} for
    each instance."""
    shared = {}
    return {(q, params): QUERIES[q](raw, spec, dtype, shared, *params)
            for q, params in set(instances)}
