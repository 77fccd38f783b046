"""The comparison that decides ``correct``.

A result (a pandas frame, as the port hands it to the user) is held
against the reference's answer (``{column: ndarray}``) column by column:

- ``mismatches``: rows of a column that is not a float which differ from
  the answer (keys, strings, counts), plus the rows missing or extra, plus
  a whole column for each column missing. Exact: its limit is 0.
- ``max_rel_err``: the largest ``|got - want| / |want|`` over the float
  columns (0 where both are 0, infinite where one is NaN and the other is
  not).
"""
from __future__ import annotations

import numpy as np

NUMBERS = ("mismatches", "max_rel_err")
MISSING = np.iinfo(np.int64).min  # a null where the answer has a number


def compare(got, want: dict) -> dict:
    if got.index.names != [None]:
        got = got.reset_index()
    n = len(next(iter(want.values())))
    out = {"mismatches": abs(len(got) - n), "max_rel_err": 0.0}
    for name, w in want.items():
        if name not in got.columns:
            out["mismatches"] += n
            continue
        g = got[name].to_numpy()
        k = min(len(g), n)
        g, w = g[:k], np.asarray(w)[:k]
        if w.dtype.kind == "f":
            g = g.astype(np.float64)
            diff = np.abs(g - w)
            scale = np.abs(w)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(diff == 0, 0.0, diff / scale)
            rel = np.where(np.isnan(g) & np.isnan(w), 0.0, rel)
            rel = np.where(np.isnan(g) ^ np.isnan(w), np.inf, rel)
            if k:
                out["max_rel_err"] = max(out["max_rel_err"], float(np.max(rel)))
        elif w.dtype.kind in "OUS":
            out["mismatches"] += int(np.sum(g.astype(str) != w.astype(str)))
        else:
            g = got[name].astype("Int64").to_numpy(dtype=np.int64, na_value=MISSING)[:k]
            out["mismatches"] += int(np.sum(g != w.astype(np.int64)))
    return out


def merge(a: dict, b: dict) -> dict:
    """The worse of two readings, number by number."""
    return {"mismatches": a["mismatches"] + b["mismatches"],
            "max_rel_err": max(a["max_rel_err"], b["max_rel_err"])}


def passes(reading: dict, limits: dict) -> bool:
    return all(reading[k] <= limits[k] for k in NUMBERS)
