"""Streaming groupby: aggregate, merge and finalize over partitions
(counterpart of ``cudf_tpu/ops/streaming_groupby.py``).

The analog of libcudf's incremental streaming groupby (reference:
cpp/src/groupby/streaming_groupby.cpp:21-38, insert/merge/aggregate) and of
cudf-polars' decomposition of distributed aggregations
(streaming/groupby.py:233: mean -> sum + count, var/std through moments,
count -> sum of counts; the MERGE_* kinds of aggregation.hpp:79-124).

Each user aggregation decomposes into mergeable partial states (sums,
counts, M2 = the sum of squared deviations from the mean, minima, maxima,
any/all); partial tables combine by a groupby over their union, and a
finalize pass computes the user's values. A partial's M2 is the in-memory
engine's two-pass M2, and M2 states merge by Chan et al.'s formula, which
subtracts no large numbers: var/std keep their digits for values with a
large mean and a small spread. (The reference merges sums of squares and
computes E[x^2] - mean^2, which cancels there; not copied.)

Partials run ``groupby.aggregate_in_memory``, the lanes of an in-memory
groupby (a partition of a CUDA table takes the one-hot kernel as the whole
table would): a partition or chunk is sized to fit the device. Merges,
over partial tables of a few rows a group, run the generic sort-based
groupby and never chunk again. Partials are computed as ``parts`` is
iterated, so only one input partition need be resident at a time.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..utils.padding import bucket_capacity
from .groupby import AggSpec, aggregate_in_memory

SUPPORTED = {"sum", "count", "size", "mean", "min", "max", "var", "std", "any", "all"}

_MERGE_KIND = {"sum": "sum", "count": "sum", "size": "sum", "min": "min",
               "max": "max", "any": "any", "all": "all"}


def _state(column: str, kind: str) -> str:
    return f"__{kind}_{column}"


def decompose(aggs: Sequence[AggSpec]) -> Tuple[List[AggSpec], Dict[str, List[str]]]:
    """User aggs -> partial-state aggs and, for each output name, the names
    of the states it is computed from."""
    partials: Dict[str, AggSpec] = {}
    mapping: Dict[str, List[str]] = {}

    def need(column, kind):
        name = _state(column, kind)
        partials[name] = AggSpec(column, kind, name)
        return name

    for a in aggs:
        if a.kind not in SUPPORTED:
            raise ValueError(f"streaming groupby cannot merge {a.kind!r}")
        if a.kind in ("sum", "mean"):
            states = [need(a.column, "sum"), need(a.column, "count")]
        elif a.kind == "count":
            states = [need(a.column, "count")]
        elif a.kind == "size":
            states = [need("", "size")]
        elif a.kind in ("min", "max", "any", "all"):
            states = [need(a.column, a.kind)]
        else:  # var, std
            states = [need(a.column, "sum"), need(a.column, "m2"), need(a.column, "count")]
        mapping[a.out_name] = states
    return list(partials.values()), mapping


def partial_aggregate(tbl: Table, keys: Sequence[str], partials: List[AggSpec],
                      dropna_keys: bool = True) -> Table:
    """One partition's partial states (the insert phase)."""
    return aggregate_in_memory(tbl, keys, partials, dropna_keys)


def merge_partials(parts: Sequence[Table], keys: Sequence[str],
                   partials: List[AggSpec]) -> Table:
    """Combine partial tables (the merge phase): concatenate, group by key,
    and merge each state by its merge kind; an M2 state with its column's
    sum and count states, by Chan et al.'s formula for n groups of rows
    (``M2 = sum M2_i + sum n_i (mean_i - mean)^2``)."""
    from .copying import concatenate_tables
    from .fastgroup import _at_group
    from .groupby import _aggregate_impl, _grouping
    from .sortprim import segment_reduce

    tbl = concatenate_tables(list(parts))
    kcols = tuple(tbl[k] for k in keys)
    perm, seg, _, live, n_groups = _grouping(kcols, dropna=False)
    out_cap = bucket_capacity(max(n_groups, 1))
    simple = tuple(AggSpec(p.out_name, _MERGE_KIND[p.kind], p.out_name)
                   for p in partials if p.kind != "m2")
    out = _aggregate_impl(kcols, tuple(tbl[a.column] for a in simple), tuple(keys), simple,
                          out_cap, perm, seg, live, n_groups, (None,) * len(simple))
    nseg = out_cap + 1
    seg_c = torch.where(live, seg.clamp(max=nseg - 1), nseg - 1)

    def seg_sum(x):
        return segment_reduce(x, seg_c, nseg, "sum", 0)[:out_cap]

    for p in partials:
        if p.kind != "m2":
            continue
        cnt = tbl[_state(p.column, "count")].data[perm].to(torch.float64)
        ok = live & (cnt > 0)  # a partial with no valid value adds nothing
        cnt = torch.where(ok, cnt, 0.0)

        def state(kind):
            c = tbl[_state(p.column, kind)]
            has = ok if c.validity is None else ok & c.validity[perm]
            return torch.where(has, c.data[perm].to(torch.float64), 0.0)

        total, s = seg_sum(cnt), state("sum")
        mean = seg_sum(s) / total.clamp(min=1)
        dev = torch.where(ok, s / cnt.clamp(min=1) - _at_group(mean, seg_c), 0.0)
        out[p.out_name] = Column(dtypes.float64, seg_sum(state("m2") + cnt * dev * dev),
                                 total > 0, n_groups)
    return Table({n: out[n] for n in list(keys) + [p.out_name for p in partials]})


def _valid_where(col: Column, ok: torch.Tensor) -> torch.Tensor:
    return ok if col.validity is None else ok & col.validity


def finalize(merged: Table, keys: Sequence[str], aggs: Sequence[AggSpec],
             mapping: Dict[str, List[str]]) -> Table:
    """The user's columns from merged partial states."""
    out = {k: merged[k] for k in keys}
    n = merged.num_rows
    for a in aggs:
        states = [merged[s] for s in mapping[a.out_name]]
        if a.kind in ("min", "max", "any", "all"):
            out[a.out_name] = states[0]
            continue
        if a.kind in ("count", "size"):
            c = states[0]
            out[a.out_name] = Column(c.dtype, c.data, None, n)
            continue
        s, c = states[0], states[-1]
        has = _valid_where(s, c.data > 0)
        if a.kind == "sum":
            out[a.out_name] = Column(s.dtype, s.data, has, n)
            continue
        cnt = c.data.to(torch.float64)
        mean = s.data.to(torch.float64) / cnt.clamp(min=1)
        if a.kind == "mean":
            out[a.out_name] = Column(dtypes.float64, mean, has, n)
            continue
        ddof = int(a.param) if a.param else 1
        var = states[1].data.to(torch.float64) / (cnt - ddof).clamp(min=1)
        has = has & (c.data > ddof)
        data = var if a.kind == "var" else torch.sqrt(var.clamp(min=0.0))
        out[a.out_name] = Column(dtypes.float64, data, has, n)
    return Table(out)


def streaming_groupby(parts: Iterable[Table], keys: Sequence[str],
                      aggs: Sequence[AggSpec], dropna_keys: bool = True,
                      n_ary: int = 32) -> Table:
    """Chunked groupby: a partial per partition, then an n-ary tree of merges
    (reference: streaming/groupby.py:385-465, n_ary=32), then finalize."""
    keys, aggs = list(keys), list(aggs)
    partials, mapping = decompose(aggs)
    states = [partial_aggregate(p, keys, partials, dropna_keys) for p in parts]
    if not states:
        raise ValueError("streaming groupby of no partitions")
    while len(states) > 1:
        states = [merge_partials(states[i:i + n_ary], keys, partials)
                  if len(states[i:i + n_ary]) > 1 else states[i]
                  for i in range(0, len(states), n_ary)]
    return finalize(states[0], keys, aggs, mapping)
