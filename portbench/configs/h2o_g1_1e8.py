"""The H2O.ai db-benchmark's groupby questions 1-9 as pandas code through
the port's DataFrame API, over its data set G1_1e8_1e2_0_0.

The data is one fixed set (``data_seed``), drawn on the card in the
distributions of the benchmark's ``groupby-datagen.R``: every column
uniform with replacement, ``id1``, ``id2`` (labels ``id001``..) and
``id4``, ``id5`` over K values, ``id3`` (labels ``id0000000001``..) and
``id6`` over N/K, ``v1`` over 1..5, ``v2`` over 1..15, ``v3`` uniform on
[0, 100) rounded to 6 decimals. The labels are the port's
sorted-dictionary string columns: codes on the card beside their
labels. Each question ends with its result on the host (``to_pandas``);
none takes parameters.
"""
from __future__ import annotations

import numpy as np

STRINGS = {"id1": ("K", 3), "id2": ("K", 3), "id3": ("N/K", 10)}


def _levels(spec: dict) -> dict:
    """How many values each id column takes: K, or N/K."""
    k = spec["datagen"]["K"]
    return {"K": k, "N/K": max(spec["tables"]["x"]["rows"] // k, 1)}


def labels(spec: dict) -> dict:
    """Each string column's dictionary, sorted: ``id`` and the value's
    number, zero-padded as groupby-datagen.R's sprintf pads it."""
    levels = _levels(spec)
    return {name: np.char.add("id", np.char.zfill(
                np.arange(1, levels[of] + 1).astype(str), width))
            for name, (of, width) in STRINGS.items()}


def generate(spec: dict, seed: int, device) -> dict:
    """x: one fixed set (``data_seed``), whatever the run's seed; a string
    column as its int32 codes, 0-based in its dictionary."""
    import torch

    n = spec["tables"]["x"]["rows"]
    levels = _levels(spec)
    g = torch.Generator(device=device)
    g.manual_seed(spec["data_seed"])

    def draw(count, low=1):
        return torch.randint(low, low + count, (n,), generator=g, device=device,
                             dtype=torch.int32)

    x = {name: draw(levels[of], 0) for name, (of, _) in STRINGS.items()}
    x.update(id4=draw(levels["K"]), id5=draw(levels["K"]), id6=draw(levels["N/K"]),
             v1=draw(5), v2=draw(15))
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    x["v3"] = torch.round(u * 100, decimals=6)
    return {"x": {c: x[c] for c in spec["tables"]["x"]["columns"]}}


def build(raw: dict, spec: dict, operations, device) -> dict:
    """The port's DataFrame over x, through its public constructors
    (DLPack; a string column as codes beside their dictionary). Takes the
    columns out of ``raw`` as it goes."""
    import cudf_tpu_torch as ctt
    from cudf_tpu_torch import Column, dtypes
    from cudf_tpu_torch.core.interop import from_dlpack

    cols, dictionaries = raw["x"], labels(spec)
    out = {}
    for name in list(cols):
        c = from_dlpack(cols.pop(name))
        if name in dictionaries:
            c = Column(dtypes.string, c.data, None, c.length, dictionary=dictionaries[name])
        out[name] = c
    return {"frame": ctt.DataFrame(out, device=device)}


def q1(state, span, params):
    return state["frame"].groupby("id1").agg({"v1": "sum"}).to_pandas()


def q2(state, span, params):
    return state["frame"].groupby(["id1", "id2"]).agg({"v1": "sum"}).to_pandas()


def q3(state, span, params):
    return state["frame"].groupby("id3").agg({"v1": "sum", "v3": "mean"}).to_pandas()


def q4(state, span, params):
    return state["frame"].groupby("id4").agg(
        {"v1": "mean", "v2": "mean", "v3": "mean"}).to_pandas()


def q5(state, span, params):
    return state["frame"].groupby("id6").agg(
        {"v1": "sum", "v2": "sum", "v3": "sum"}).to_pandas()


def q6(state, span, params):
    return state["frame"].groupby(["id4", "id5"]).agg(
        {"v3": ["median", "std"]}).to_pandas()


def q7(state, span, params):
    out = state["frame"].groupby("id3", as_index=False).agg({"v1": "max", "v2": "min"})
    out["range_v1_v2"] = out["v1"] - out["v2"]
    return out[["id3", "range_v1_v2"]].to_pandas()


def q8(state, span, params):
    df = state["frame"][["id6", "v3"]]
    return df.sort_values("v3", ascending=False).groupby("id6").head(2).to_pandas()


def q9(state, span, params):
    c = state["frame"].groupby(["id2", "id4"])[["v1", "v2"]].corr().reset_index()
    v1 = c[c["level_2"] == "v1"]
    out = v1[["id2", "id4"]]
    out["r2"] = v1["v2"] ** 2
    return out.to_pandas()


OPERATIONS = {f"q{i}": fn for i, fn in enumerate((q1, q2, q3, q4, q5, q6, q7, q8, q9), 1)}
