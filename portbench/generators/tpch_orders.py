"""TPC-H's data for the per-order queries Q18 and Q21, drawn on the device
from a seed by the rules of the specification's section 4.2.3 (v3.0.1).

The rules of ``generators/tpch.py`` hold for every column drawn there
(sparse order keys, 1 to 7 lines an order, a part's four suppliers, the
quantity, the dates); this module draws the columns those queries read
beside them:

- ``L_COMMITDATE``: the order date + 30 to 90 days;
- ``L_RECEIPTDATE``: the ship date + 1 to 30 days;
- ``O_TOTALPRICE``: the sum over the order's lines of
  ``L_EXTENDEDPRICE * (1 + L_TAX) * (1 - L_DISCOUNT)``, in integer cents as
  dbgen's ``mk_order`` sums it: each line's price less its discount
  truncated to a cent, then with its tax truncated to a cent, the cents
  summed exactly in int64 and divided by 100 once;
- ``O_ORDERSTATUS``: F where every line of the order is F (shipped by
  CURRENTDATE), O where every line is O, else P;
- ``C_NAME`` and ``S_NAME``: ``Customer#`` and ``Supplier#`` with the key in
  9 digits, so each dictionary sorted is in key order and a row's code is
  its key - 1.

The ship date, extended price, discount and tax are drawn for the status
and the total price; lineitem holds them where the spec lists them.
Strings are int32 codes into sorted dictionaries (``dictionaries``),
dates int64 nanoseconds since 1970, decimals float64.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.generators.tpch import (CURRENT_DAY, DAY_NS, LAST_ORDER_DAY, NATIONS, START,
                                       retail_cents, sparse_keys)

STATUS = ["F", "O", "P"]  # O_ORDERSTATUS's dictionary, sorted
NATION_NAMES = sorted(n for n, _ in NATIONS)


def names(prefix: str, n: int) -> np.ndarray:
    """``prefix`` + 1 .. n in 9 digits: the sorted dictionary of C_NAME or
    S_NAME."""
    return np.char.add(prefix, np.char.zfill(np.arange(1, n + 1).astype(str), 9))


def dictionaries(spec: dict) -> dict:
    """Each string column's sorted dictionary, at the spec's sizes."""
    sizes = spec["dbgen"]
    return {"c_name": names("Customer#", sizes["customers"]),
            "s_name": names("Supplier#", sizes["suppliers"]),
            "n_name": np.array(NATION_NAMES), "o_orderstatus": np.array(STATUS)}


def generate(spec: dict, seed: int, device) -> dict:
    """{table: {column: tensor}} on ``device``, all of it drawn from ``seed``;
    each table holds the columns ``spec["tables"]`` lists."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = spec["dbgen"]
    n_ord, n_cust = sizes["orders"], sizes["customers"]
    n_supp, n_part = sizes["suppliers"], sizes["parts"]
    i64 = torch.int64

    def ints(lo, hi, n):
        """Uniform over lo .. hi, both included."""
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device, dtype=i64)

    o_day = ints(0, LAST_ORDER_DAY, n_ord)
    lines = ints(1, 7, n_ord)
    n_li = int(lines.sum())
    order_of = torch.repeat_interleave(torch.arange(n_ord, device=device), lines,
                                       output_size=n_li)
    commit = o_day[order_of]
    ship = commit + ints(1, 121, n_li)
    commit += ints(30, 90, n_li)
    shipped = (ship <= CURRENT_DAY).to(i64)        # L_LINESTATUS F
    receipt = ship + ints(1, 30, n_li)
    partkey = ints(1, n_part, n_li)
    suppkey = torch.remainder(
        partkey + ints(0, 3, n_li) * (n_supp // 4 + (partkey - 1) // n_supp), n_supp) + 1
    quantity = ints(1, 50, n_li)
    price = quantity * retail_cents(partkey)       # L_EXTENDEDPRICE in cents
    del partkey
    discount, tax = ints(0, 10, n_li), ints(0, 8, n_li)   # in hundredths
    cents = price * (100 - discount) // 100 * (100 + tax) // 100
    total = torch.zeros(n_ord, device=device, dtype=i64).index_add_(0, order_of, cents)
    del cents
    n_shipped = torch.zeros(n_ord, device=device, dtype=i64).index_add_(0, order_of, shipped)
    del shipped
    status = torch.where(n_shipped == lines, 0, torch.where(n_shipped == 0, 1, 2))
    del n_shipped, lines

    o_key = sparse_keys(n_ord, device)
    lineitem = {"l_orderkey": o_key[order_of], "l_suppkey": suppkey,
                "l_quantity": quantity.to(torch.float64),
                "l_commitdate": START + commit * DAY_NS,
                "l_receiptdate": START + receipt * DAY_NS,
                "l_shipdate": START + ship * DAY_NS,
                "l_extendedprice": price.to(torch.float64) / 100,
                "l_discount": discount.to(torch.float64) / 100,
                "l_tax": tax.to(torch.float64) / 100}
    del order_of, suppkey, quantity, commit, ship, receipt, price, discount, tax

    cust = ints(1, n_cust, n_ord)
    cust = torch.where(torch.remainder(cust, 3) == 0,
                       torch.where(cust == n_cust, cust - 1, cust + 1), cust)
    orders = {"o_orderkey": o_key, "o_custkey": cust, "o_orderdate": START + o_day * DAY_NS,
              "o_totalprice": total.to(torch.float64) / 100,
              "o_orderstatus": status.to(torch.int32)}
    customer = {"c_custkey": torch.arange(1, n_cust + 1, device=device, dtype=i64),
                "c_name": torch.arange(n_cust, device=device, dtype=torch.int32)}
    supplier = {"s_suppkey": torch.arange(1, n_supp + 1, device=device, dtype=i64),
                "s_name": torch.arange(n_supp, device=device, dtype=torch.int32),
                "s_nationkey": ints(0, len(NATIONS) - 1, n_supp)}
    nation = {"n_nationkey": torch.arange(len(NATIONS), device=device, dtype=i64),
              "n_name": torch.tensor([NATION_NAMES.index(n) for n, _ in NATIONS],
                                     device=device, dtype=torch.int32)}
    tables = dict(lineitem=lineitem, orders=orders, customer=customer, supplier=supplier,
                  nation=nation)
    return {t: {c: cols[c] for c in spec["tables"][t]["columns"]}
            for t, cols in tables.items()}
