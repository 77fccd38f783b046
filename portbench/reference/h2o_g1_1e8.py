"""The db-benchmark groupby questions 1-9 in plain torch, from the raw
columns of ``configs/h2o_g1_1e8.py:generate``.

Groups come from ``torch.unique`` over one code a row (``plain.codes``),
in ascending key order; sums by ``index_add_``, max and min by
``scatter_reduce``, counts by ``bincount``. A median sorts each group's
values (one sort by value, then a stable one by group) and averages the
two middle ones; std is the two-pass one with ddof 1; r2 comes from exact
int64 moments of the integer columns, r = C / sqrt(A·B). q8 sorts by v3
descending (stable, so ties keep their row order) and keeps each id6's
first two rows in that order. The float values are rounded to ``dtype``
and each row's arithmetic is done in it; every sum and mean accumulates in
float64 (the control rounds to float32 and keeps that accumulator).
Besides the answer, each keyed ``groupby().agg`` or ``corr`` reports its
rows, keys, reads and groups, which ``groupby_roofline`` counts bytes
from; q8's grouped head is no aggregation and reports none.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain import codes

ACC = torch.float64
STRINGS = {"id1": 3, "id2": 3, "id3": 10}  # the labels' zero-padded widths


def _label(name: str, code: torch.Tensor) -> np.ndarray:
    """The labels of 0-based codes: ``id`` and the number, zero-padded."""
    return np.char.add("id", np.char.zfill((_host(code) + 1).astype(str), STRINGS[name])
                       ).astype(object)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).cpu().numpy()


class _Groups:
    """The groups of ``keys`` (int tensors), in ascending key order."""

    def __init__(self, keys: list):
        uniq, self.inv = torch.unique(codes(keys), return_inverse=True)
        self.n = len(uniq)
        rows = torch.arange(len(self.inv), device=self.inv.device)
        first = torch.full((self.n,), len(self.inv), dtype=torch.int64, device=rows.device)
        first.scatter_reduce_(0, self.inv, rows, "amin")
        self.keys = [k[first] for k in keys]
        self.count = torch.bincount(self.inv, minlength=self.n)

    def sum(self, v: torch.Tensor, acc) -> torch.Tensor:
        return torch.zeros(self.n, dtype=acc, device=v.device).index_add_(0, self.inv, v.to(acc))

    def reduce(self, v: torch.Tensor, how: str) -> torch.Tensor:
        init = torch.iinfo(v.dtype).max if how == "amin" else torch.iinfo(v.dtype).min
        out = torch.full((self.n,), init, dtype=v.dtype, device=v.device)
        return out.scatter_reduce_(0, self.inv, v, how)

    def mean(self, v: torch.Tensor) -> torch.Tensor:
        return self.sum(v, ACC) / self.count.to(ACC)


def _keyed(names, g: _Groups) -> dict:
    return {n: (_label(n, k) if n in STRINGS else _host(k))
            for n, k in zip(names, g.keys)}


def _groupby(rows, keys, reads, groups, out) -> dict:
    return {"rows": int(rows), "keys": keys, "reads": reads, "groups": int(groups),
            "out": out}


def _q_by(x, dtype, q):
    """The answer of one groupby question, and its counts."""
    n = len(x["v1"])
    v3 = x["v3"].to(dtype)
    if q == "q1":
        g = _Groups([x["id1"]])
        ans = {**_keyed(["id1"], g), "v1": _host(g.sum(x["v1"], torch.int64))}
        return ans, _groupby(n, ["id1"], ["v1"], g.n, ["int64"])
    if q == "q2":
        g = _Groups([x["id1"], x["id2"]])
        ans = {**_keyed(["id1", "id2"], g), "v1": _host(g.sum(x["v1"], torch.int64))}
        return ans, _groupby(n, ["id1", "id2"], ["v1"], g.n, ["int64"])
    if q == "q3":
        g = _Groups([x["id3"]])
        ans = {**_keyed(["id3"], g), "v1": _host(g.sum(x["v1"], torch.int64)),
               "v3": _f64(g.mean(v3))}
        return ans, _groupby(n, ["id3"], ["v1", "v3"], g.n, ["int64", "float64"])
    if q == "q4":
        g = _Groups([x["id4"]])
        ans = {**_keyed(["id4"], g), "v1": _f64(g.mean(x["v1"])),
               "v2": _f64(g.mean(x["v2"])), "v3": _f64(g.mean(v3))}
        return ans, _groupby(n, ["id4"], ["v1", "v2", "v3"], g.n, ["float64"] * 3)
    if q == "q5":
        g = _Groups([x["id6"]])
        ans = {**_keyed(["id6"], g), "v1": _host(g.sum(x["v1"], torch.int64)),
               "v2": _host(g.sum(x["v2"], torch.int64)), "v3": _f64(g.sum(v3, ACC))}
        return ans, _groupby(n, ["id6"], ["v1", "v2", "v3"], g.n,
                             ["int64", "int64", "float64"])
    if q == "q6":
        g = _Groups([x["id4"], x["id5"]])
        by_value = torch.sort(v3, stable=True).indices
        order = by_value[torch.sort(g.inv[by_value], stable=True).indices]
        s = v3[order].to(ACC)
        start = torch.cumsum(g.count, 0) - g.count
        median = (s[start + (g.count - 1) // 2] + s[start + g.count // 2]) / 2
        mean = g.mean(v3)
        d = v3.to(ACC) - mean[g.inv]
        std = torch.sqrt(g.sum(d * d, ACC) / (g.count - 1).to(ACC))
        std = torch.where(g.count > 1, std, float("nan"))
        ans = {**_keyed(["id4", "id5"], g), "v3_median": _f64(median),
               "v3_std": _f64(std)}
        return ans, _groupby(n, ["id4", "id5"], ["v3"], g.n, ["float64", "float64"])
    if q == "q7":
        g = _Groups([x["id3"]])
        r = g.reduce(x["v1"], "amax").to(torch.int64) - g.reduce(x["v2"], "amin")
        ans = {**_keyed(["id3"], g), "range_v1_v2": _host(r)}
        return ans, _groupby(n, ["id3"], ["v1", "v2"], g.n, ["int32", "int32"])
    if q == "q9":
        g = _Groups([x["id2"], x["id4"]])
        a, b = x["v1"].to(torch.int64), x["v2"].to(torch.int64)
        m = g.count
        sa, sb = g.sum(a, torch.int64), g.sum(b, torch.int64)
        c = m * g.sum(a * b, torch.int64) - sa * sb
        va = m * g.sum(a * a, torch.int64) - sa * sa
        vb = m * g.sum(b * b, torch.int64) - sb * sb
        r = c.to(ACC) / torch.sqrt(va.to(ACC) * vb.to(ACC))
        ok = (m >= 2) & (va > 0) & (vb > 0)
        ans = {**_keyed(["id2", "id4"], g),
               "r2": _f64(torch.where(ok, r * r, float("nan")))}
        return ans, _groupby(n, ["id2", "id4"], ["v1", "v2"], g.n, ["float64"])
    raise KeyError(q)


def _q8(x, dtype):
    """The two largest v3 of each id6, in v3's descending order (ties in
    row order), with their id6."""
    v3 = x["v3"].to(dtype)
    order = torch.sort(v3, descending=True, stable=True).indices
    g = x["id6"][order]
    by_group = torch.sort(g, stable=True).indices
    sg = g[by_group]
    pos = torch.arange(len(sg), device=sg.device)
    new = torch.ones_like(sg, dtype=torch.bool)
    new[1:] = sg[1:] != sg[:-1]
    start = torch.cummax(torch.where(new, pos, 0), 0).values
    keep = torch.zeros_like(new)
    keep[by_group] = pos - start < 2
    rows = order[keep]
    return {"id6": _host(x["id6"][rows]), "v3": _f64(v3[rows])}


def answers(raw: dict, spec: dict, instances, dtype) -> dict:
    """{(operation, parameters): (answer: {column: ndarray}, counts)} for
    each instance."""
    x = raw["x"]
    out = {}
    for q, params in set(instances):
        if q == "q8":
            out[(q, params)] = (_q8(x, dtype), {"joins": [], "groupbys": []})
        else:
            ans, gb = _q_by(x, dtype, q)
            out[(q, params)] = (ans, {"joins": [], "groupbys": [gb]})
    return out
