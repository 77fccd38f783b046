"""TPC-H Q1 as pandas code through the port's DataFrame API, at SF30.

``q1`` runs on a frame resident on the card; ``ingest_q1`` first ingests
a host pandas frame with ``from_pandas``, as a cudf.pandas script does,
and frees the frame after. Both bring the result to the host with
``to_pandas``. The data is ``portbench.generators.tpch``'s lineitem, one
fixed set (``data_seed``); each execution draws Q1's DELTA from the
run's seed (``PARAMETERS``).
"""
from __future__ import annotations

import numpy as np

from portbench.generators import qgen
from portbench.generators import tpch as dbgen
from portbench.generators.tpch import DICTIONARIES

KEYS = ["l_returnflag", "l_linestatus"]


def generate(spec: dict, seed: int, device) -> dict:
    """lineitem: one fixed set (``data_seed``), whatever the run's seed."""
    return dbgen.generate(spec, spec["data_seed"], device, lineitem_only=True)


def _frame(cols: dict, spec: dict, device):
    """The port's DataFrame over the columns, through its public
    constructors (DLPack; a string column as codes beside their
    dictionary). Takes the columns out of ``cols`` as it goes."""
    import cudf_tpu_torch as ctt
    from cudf_tpu_torch import Column, dtypes
    from cudf_tpu_torch.core.interop import from_dlpack

    kinds = spec["tables"]["lineitem"]["columns"]
    out = {}
    for name in list(cols):
        t = cols.pop(name)
        if kinds[name] == "string":
            c = from_dlpack(t)
            out[name] = Column(dtypes.string, c.data, None, c.length,
                               dictionary=np.array(DICTIONARIES[name]))
        elif kinds[name] == "timestamp[ns]":
            out[name] = from_dlpack(t, dtypes.timestamp("ns"))
        else:
            out[name] = from_dlpack(t)
    return ctt.DataFrame(out, device=device)


def _host_frame(cols: dict, spec: dict):
    """The same columns as a host pandas frame: Categorical strings,
    datetime64[ns] dates, float64 decimals."""
    import pandas as pd

    kinds = spec["tables"]["lineitem"]["columns"]
    data = {}
    for name, t in cols.items():
        a = t.cpu().numpy()
        if kinds[name] == "string":
            a = pd.Categorical.from_codes(a, categories=DICTIONARIES[name])
        elif kinds[name] == "timestamp[ns]":
            a = a.view("datetime64[ns]")
        data[name] = a
    return pd.DataFrame(data)


def build(raw: dict, spec: dict, operations, device) -> dict:
    cols, state = raw["lineitem"], {"device": device}
    if "ingest_q1" in operations:
        state["host"] = _host_frame(cols, spec)
    if "q1" in operations:
        state["frame"] = _frame(cols, spec, device)
    return state


def _q1(df, delta):
    """TPC-H Q1 as a pandas user writes it."""
    f = df[df["l_shipdate"] <= qgen.q1_cutoff(delta)]
    f["disc_price"] = f["l_extendedprice"] * (1.0 - f["l_discount"])
    f["charge"] = f["disc_price"] * (1.0 + f["l_tax"])
    out = f.groupby(KEYS, as_index=False).agg(
        sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"), avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"))
    return out.sort_values(KEYS).to_pandas()


def q1(state, span, params):
    return _q1(state["frame"], *params)


def ingest_q1(state, span, params):
    import cudf_tpu_torch as ctt

    with span("portbench.from_pandas"):
        frame = ctt.from_pandas(state["host"], device=state["device"])
    out = _q1(frame, *params)
    del frame
    return out


OPERATIONS = {"q1": q1, "ingest_q1": ingest_q1}
PARAMETERS = {"q1": qgen.q1, "ingest_q1": qgen.q1}
