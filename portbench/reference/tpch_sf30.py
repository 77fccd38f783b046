"""TPC-H q1, q3, q5 and q6 in plain torch, from the generated tables,
for a set of substitution parameters.

Each query's filters, equi-joins (``plain.lookup``: every build side of
these plans has distinct keys) and groupbys are worked out again here.
The values are rounded to ``dtype`` and each row's arithmetic is done in
it; every sum and mean accumulates in float64 (the control rounds the
values to float32 and keeps that accumulator). Besides the answer, each query reports what its joins
and keyed groupbys see (rows after the filters, matched pairs, groups),
which the rooflines count bytes from.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.generators.qgen import q1_cutoff
from portbench.generators.tpch import DICTIONARIES as DICT
from portbench.reference.plain import group, lookup

ACC = torch.float64


def _ns(day: str) -> int:
    return int(np.datetime64(day, "ns").astype(np.int64))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).cpu().numpy()


def _strings(column: str, code: torch.Tensor) -> np.ndarray:
    return np.array(DICT[column], dtype=object)[_host(code)]


def _join(name, left_rows, left_keys, right_rows, right_keys, pairs) -> dict:
    return {"join": name, "left_rows": int(left_rows), "left_keys": left_keys,
            "right_rows": int(right_rows), "right_keys": right_keys, "pairs": int(pairs)}


def _groupby(rows, keys, reads, groups, out) -> dict:
    return {"rows": int(rows), "keys": keys, "reads": reads, "groups": int(groups),
            "out": out}


def q1(t, dtype, delta):
    """Q1's groups are (flag, status) code pairs: each row's pair as one
    small code, rows past the cutoff in a bin of their own, and each
    group's sums as masked sums in float64."""
    li = t["lineitem"]
    m = li["l_shipdate"] <= int(q1_cutoff(delta).astype(np.int64))
    n_status = len(DICT["l_linestatus"])
    bins = len(DICT["l_returnflag"]) * n_status
    code = torch.where(m, li["l_returnflag"].to(torch.int64) * n_status + li["l_linestatus"],
                       bins)
    qty, price = li["l_quantity"].to(dtype), li["l_extendedprice"].to(dtype)
    disc, tax = li["l_discount"].to(dtype), li["l_tax"].to(dtype)
    disc_price = price * (1 - disc)
    values = {"qty": qty, "price": price, "disc": disc, "disc_price": disc_price,
              "charge": disc_price * (1 + tax)}
    n = torch.bincount(code, minlength=bins + 1)[:bins]
    groups = torch.nonzero(n).squeeze(1)
    s = {k: torch.stack([torch.where(code == g, v, 0).to(ACC).sum() for g in groups.tolist()])
         for k, v in values.items()}
    n = n[groups]
    nd = n.to(ACC)
    answer = {
        "l_returnflag": _strings("l_returnflag", groups // n_status),
        "l_linestatus": _strings("l_linestatus", groups % n_status),
        "sum_qty": _f64(s["qty"]), "sum_base_price": _f64(s["price"]),
        "sum_disc_price": _f64(s["disc_price"]), "sum_charge": _f64(s["charge"]),
        "avg_qty": _f64(s["qty"] / nd), "avg_price": _f64(s["price"] / nd),
        "avg_disc": _f64(s["disc"] / nd), "count_order": _host(n),
    }
    counts = {"joins": [], "groupbys": [_groupby(
        int(m.sum()), ["l_returnflag", "l_linestatus"],
        ["l_quantity", "l_extendedprice", "l_discount", "l_tax"], len(n),
        ["float64"] * 7 + ["int64"])]}
    return answer, counts


def q3(t, dtype, segment, day):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    cut = _ns(day)
    cm = c["c_mktsegment"] == DICT["c_mktsegment"].index(segment)
    om = o["o_orderdate"] < cut
    lm = li["l_shipdate"] > cut
    c_key = c["c_custkey"][cm]
    o_key, o_cust, o_prio = o["o_orderkey"][om], o["o_custkey"][om], o["o_shippriority"][om]
    hit = lookup([c_key], [o_cust]) >= 0
    j1 = _join("customer-orders", len(c_key), ["c_custkey"], len(o_key), ["o_custkey"],
               int(hit.sum()))
    o_key, o_prio = o_key[hit], o_prio[hit]
    l_key = li["l_orderkey"][lm]
    row = lookup([o_key], [l_key])
    lh = row >= 0
    j2 = _join("orders-lineitem", len(o_key), ["o_orderkey"], len(l_key), ["l_orderkey"],
               int(lh.sum()))
    row = row[lh]
    price = li["l_extendedprice"][lm][lh].to(dtype)
    disc = li["l_discount"][lm][lh].to(dtype)
    keys, s, _ = group([o_key[row], o_prio[row]], {"revenue": price * (1 - disc)}, ACC)
    rev = s["revenue"]
    order = torch.sort(rev, descending=True, stable=True).indices[:10]
    answer = {"o_orderkey": _host(keys[0][order]), "o_shippriority": _host(keys[1][order]),
              "revenue": _f64(rev[order])}
    counts = {"joins": [j1, j2], "groupbys": [_groupby(
        len(row), ["o_orderkey", "o_shippriority"], ["l_extendedprice", "l_discount"],
        len(rev), ["float64"])]}
    return answer, counts


def q5(t, dtype, region, year):
    r, n, s = t["region"], t["nation"], t["supplier"]
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    rm = r["r_name"] == DICT["r_name"].index(region)
    r_key = r["r_regionkey"][rm]
    nh = lookup([r_key], [n["n_regionkey"]]) >= 0
    j1 = _join("region-nation", len(r_key), ["r_regionkey"], len(nh), ["n_regionkey"],
               int(nh.sum()))
    n_key, n_name = n["n_nationkey"][nh], n["n_name"][nh]
    srow = lookup([n_key], [s["s_nationkey"]])
    sh = srow >= 0
    j2 = _join("nation-supplier", len(n_key), ["n_nationkey"], len(sh), ["s_nationkey"],
               int(sh.sum()))
    s_key, s_nat, s_name = s["s_suppkey"][sh], s["s_nationkey"][sh], n_name[srow[sh]]

    om = (o["o_orderdate"] >= _ns(f"{year}-01-01")) & (o["o_orderdate"] < _ns(f"{year + 1}-01-01"))
    o_key, o_cust = o["o_orderkey"][om], o["o_custkey"][om]
    crow = lookup([c["c_custkey"]], [o_cust])
    ch = crow >= 0
    j3 = _join("customer-orders", len(c["c_custkey"]), ["c_custkey"],
               len(o_key), ["o_custkey"], int(ch.sum()))
    o_key, o_nat = o_key[ch], c["c_nationkey"][crow[ch]]
    lrow = lookup([o_key], [li["l_orderkey"]])
    lh = lrow >= 0
    j4 = _join("orders-lineitem", len(o_key), ["o_orderkey"], len(lh), ["l_orderkey"],
               int(lh.sum()))
    l_supp, l_nat = li["l_suppkey"][lh], o_nat[lrow[lh]]
    final = lookup([s_key, s_nat], [l_supp, l_nat])
    fh = final >= 0
    j5 = _join("supplier-lineitem", len(s_key), ["s_suppkey", "s_nationkey"], len(fh),
               ["l_suppkey", "c_nationkey"], int(fh.sum()))
    price = li["l_extendedprice"][lh][fh].to(dtype)
    disc = li["l_discount"][lh][fh].to(dtype)
    keys, sums, _ = group([s_name[final[fh]]], {"revenue": price * (1 - disc)}, ACC)
    rev = sums["revenue"]
    order = torch.sort(rev, descending=True, stable=True).indices
    answer = {"n_name": _strings("n_name", keys[0][order]), "revenue": _f64(rev[order])}
    counts = {"joins": [j1, j2, j3, j4, j5], "groupbys": [_groupby(
        int(fh.sum()), ["n_name"], ["l_extendedprice", "l_discount"], len(rev),
        ["float64"])]}
    return answer, counts


def q6(t, dtype, year, discount, quantity):
    li = t["lineitem"]
    m = ((li["l_shipdate"] >= _ns(f"{year}-01-01")) & (li["l_shipdate"] < _ns(f"{year + 1}-01-01"))
         & (li["l_discount"] >= (discount - 1) / 100) & (li["l_discount"] <= (discount + 1) / 100)
         & (li["l_quantity"] < float(quantity)))
    rev = (li["l_extendedprice"][m].to(dtype) * li["l_discount"][m].to(dtype)).to(ACC).sum()
    return {"revenue": _f64(rev.reshape(1))}, {"joins": [], "groupbys": []}


QUERIES = {"q1": q1, "q3": q3, "q5": q5, "q6": q6}


def answers(raw: dict, spec: dict, instances, dtype) -> dict:
    """{(operation, parameters): (answer: {column: ndarray}, counts)} for
    each instance."""
    return {(q, params): QUERIES[q](raw, dtype, *params) for q, params in set(instances)}
