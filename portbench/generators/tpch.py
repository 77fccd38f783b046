"""TPC-H's data, drawn on the device from a seed by the rules of the
specification's section 4.2.3 (v3.0.1), for the columns that the queries
read.

- orders: ``O_ORDERKEY`` sparse as dbgen's ``mk_sparse`` makes it (of each
  32 keys the first 8 are used); ``O_CUSTKEY`` uniform over the customers
  but never a multiple of 3 (dbgen moves such a key to the next one, so a
  third of the customers have no order); ``O_ORDERDATE`` uniform from
  STARTDATE to ENDDATE - 151 days; ``O_SHIPPRIORITY`` 0.
- lineitem: 1 to 7 lines an order, in order-key order as dbgen writes
  them; ``L_PARTKEY`` uniform over SF x 200,000 parts and ``L_SUPPKEY``
  one of the part's four suppliers; ``L_QUANTITY`` 1 to 50;
  ``L_EXTENDEDPRICE`` the quantity times the part's ``P_RETAILPRICE``;
  ``L_DISCOUNT`` 0.00 to 0.10 and ``L_TAX`` 0.00 to 0.08 in steps of
  0.01; ``L_SHIPDATE`` the order date + 1 to 121 days and the receipt
  date that + 1 to 30; ``L_RETURNFLAG`` R or A at random where the
  receipt date is not after CURRENTDATE, else N; ``L_LINESTATUS`` O where
  the ship date is after CURRENTDATE, else F.
- customer, supplier: dense keys from 1; nation and segment uniform.
- nation, region: the specification's fixed rows.

A string column holds int32 codes into its sorted dictionary
(``DICTIONARIES``); dates are int64 nanoseconds since 1970; decimals are
float64. The counts of orders, customers, suppliers and parts come from
``spec["dbgen"]`` (SF x 1,500,000, 150,000, 10,000 and 200,000);
lineitem's size follows from the orders (about SF x 6,000,000).
"""
from __future__ import annotations

import numpy as np
import torch

DAY_NS = 86_400 * 10**9
START = int(np.datetime64("1992-01-01", "ns").astype(np.int64))
CURRENT_DAY = 1263        # 1995-06-17, days after STARTDATE
LAST_ORDER_DAY = 2405     # ENDDATE 1998-12-31 - 151 days

NATIONS = [  # (N_NAME, N_REGIONKEY) by N_NATIONKEY
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1)]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]  # by R_REGIONKEY
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]

DICTIONARIES = {"l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"],
                "c_mktsegment": SEGMENTS, "n_name": sorted(n for n, _ in NATIONS),
                "r_name": sorted(REGIONS)}


def sparse_keys(n: int, device) -> torch.Tensor:
    """dbgen's ``mk_sparse`` of 1 .. n: the low 3 bits kept, the rest
    shifted up by 2."""
    i = torch.arange(1, n + 1, device=device, dtype=torch.int64)
    return ((i >> 3) << 5) + (i & 7)


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents: 90000 + (key / 10) mod 20001 + 100 (key mod 1000)."""
    return 90000 + torch.remainder(partkey // 10, 20001) + 100 * torch.remainder(partkey, 1000)


def generate(spec: dict, seed: int, device, lineitem_only: bool = False) -> dict:
    """{table: {column: tensor}} on ``device``, all of it drawn from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = spec["dbgen"]
    n_ord, n_cust = sizes["orders"], sizes["customers"]
    n_supp, n_part = sizes["suppliers"], sizes["parts"]

    def ints(lo, hi, n, dtype=torch.int64):
        """Uniform over lo .. hi, both included."""
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device, dtype=dtype)

    o_day = ints(0, LAST_ORDER_DAY, n_ord)
    lines = ints(1, 7, n_ord)
    o_key = sparse_keys(n_ord, device)
    n_li = int(lines.sum())
    order_of = torch.repeat_interleave(torch.arange(n_ord, device=device), lines,
                                       output_size=n_li)
    del lines
    ship_day = o_day[order_of] + ints(1, 121, n_li)
    receipt_day = ship_day + ints(1, 30, n_li)
    returned = ints(0, 1, n_li, torch.int32) * 2   # A (0) or R (2)
    partkey = ints(1, n_part, n_li)
    which = ints(0, 3, n_li)
    suppkey = torch.remainder(partkey + which * (n_supp // 4 + (partkey - 1) // n_supp),
                              n_supp) + 1
    del which
    quantity = ints(1, 50, n_li)
    lineitem = {
        "l_orderkey": o_key[order_of],
        "l_suppkey": suppkey,
        "l_quantity": quantity.to(torch.float64),
        "l_extendedprice": (quantity * retail_cents(partkey)).to(torch.float64) / 100,
        "l_discount": ints(0, 10, n_li).to(torch.float64) / 100,
        "l_tax": ints(0, 8, n_li).to(torch.float64) / 100,
        "l_returnflag": torch.where(receipt_day <= CURRENT_DAY, returned,
                                    torch.ones_like(returned)),
        "l_linestatus": (ship_day > CURRENT_DAY).to(torch.int32),
        "l_shipdate": START + ship_day * DAY_NS,
    }
    del order_of, receipt_day, returned, partkey, quantity, ship_day, suppkey
    wanted = spec["tables"]["lineitem"]["columns"]
    lineitem = {k: v for k, v in lineitem.items() if k in wanted}
    if lineitem_only:
        return {"lineitem": lineitem}

    cust = ints(1, n_cust, n_ord)
    cust = torch.where(torch.remainder(cust, 3) == 0,
                       torch.where(cust == n_cust, cust - 1, cust + 1), cust)
    orders = {"o_orderkey": o_key, "o_custkey": cust, "o_orderdate": START + o_day * DAY_NS,
              "o_shippriority": torch.zeros(n_ord, device=device, dtype=torch.int64)}
    customer = {"c_custkey": torch.arange(1, n_cust + 1, device=device, dtype=torch.int64),
                "c_mktsegment": ints(0, len(SEGMENTS) - 1, n_cust, torch.int32),
                "c_nationkey": ints(0, len(NATIONS) - 1, n_cust)}
    supplier = {"s_suppkey": torch.arange(1, n_supp + 1, device=device, dtype=torch.int64),
                "s_nationkey": ints(0, len(NATIONS) - 1, n_supp)}
    names = DICTIONARIES["n_name"]
    nation = {"n_nationkey": torch.arange(len(NATIONS), device=device, dtype=torch.int64),
              "n_name": torch.tensor([names.index(n) for n, _ in NATIONS], device=device,
                                     dtype=torch.int32),
              "n_regionkey": torch.tensor([r for _, r in NATIONS], device=device,
                                          dtype=torch.int64)}
    region = {"r_regionkey": torch.arange(len(REGIONS), device=device, dtype=torch.int64),
              "r_name": torch.tensor([DICTIONARIES["r_name"].index(r) for r in REGIONS],
                                     device=device, dtype=torch.int32)}
    return dict(lineitem=lineitem, orders=orders, customer=customer, supplier=supplier,
                nation=nation, region=region)
