"""Plan lowering: statistics-driven PartitionInfo, Shuffle and Repartition
insertion (counterpart of ``cudf_tpu/expr/lowering.py``).

The rebuild of cudf-polars' streaming lowering (reference:
streaming/parallel.py:68-117 ``lower_ir_graph`` rewrites the logical plan
bottom-up, giving each node a PartitionInfo; join lowering
streaming/join.py:57-147 picks broadcast or shuffle by a byte budget;
partition-count heuristics utils/config.py:277-294; statistics
streaming/statistics.py:25). ``parallel/plan_executor.execute_partitioned``
runs the lowered plan; the in-memory executor (``expr/ir.py:execute``)
treats Shuffle and Repartition as no-ops, so one IR serves both.

The lowered plan is the reference's for the same plan, data and config,
with one exception, a fault of the reference not copied: its keyless
``GroupBy`` (``keys == ()``) equals a child's default ``partitioned_on ==
()``, so it is taken for co-partitioned and aggregates each partition on
its own (one row per partition); here it gets a ``Repartition(1)``, as
``Reduce`` does, and gives one row.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .ir import (IR, Cache, ConditionalJoin, DataFrameScan, Distinct, Empty,
                 Filter, GroupBy, HConcat, HStack, Join, MapFunction,
                 MergeSorted, Projection, Reduce, Repartition, Rolling, Scan,
                 Select, Shuffle, Sink, Slice, Sort, Union)
from ..core.table import Deferred
from .nodebase import CachingVisitor


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    """Partitioning state of one plan node's output."""

    count: int
    partitioned_on: Tuple[str, ...] = ()  # hash-partition keys ('' = none)


@dataclasses.dataclass(frozen=True)
class LoweringConfig:
    """reference utils/config.py:277-294 heuristics (the reference's values)."""

    target_partition_bytes: int = 256 << 20
    broadcast_limit_bytes: int = 64 << 20     # small-side replication budget
    max_partitions: int = 256


def _estimate_bytes(node: IR, _cache: Optional[dict] = None) -> Optional[int]:
    """Row-count/byte statistics (reference streaming/statistics.py:25).

    Memoized per-node (by identity): plans are DAGs, and an unmemoized walk
    re-visits shared subtrees exponentially often."""
    if _cache is None:
        _cache = {}
    key = id(node)
    if key in _cache:
        return _cache[key]
    out = _estimate_bytes_impl(node, _cache)
    _cache[key] = out
    return out


def _estimate_bytes_impl(node: IR, _cache: dict) -> Optional[int]:
    if isinstance(node, DataFrameScan):
        t = node._tbl
        total = 0
        for c in t._columns.values():
            # a deferred column is not decoded to be measured: its width
            # comes from the file's schema (a string holds int32 codes)
            if isinstance(c, Deferred):
                width, nullable = (4 if c.np_dtype == object else c.np_dtype.itemsize), False
            else:
                width, nullable = max(c.dtype.bits // 8, 1), c.validity is not None
            total += t.num_rows * width + (t.num_rows if nullable else 0)
        return total
    if isinstance(node, Scan):
        import os

        fmt, paths, columns, _ = node.args
        try:
            raw = sum(os.path.getsize(p) for p in paths)
        except OSError:
            return None
        # parquet ~3x compression typical; csv/json ~1x
        return raw * 3 if fmt == "parquet" else raw
    if node.children:
        sizes = [_estimate_bytes(c, _cache) for c in node.children]
        if any(s is None for s in sizes):
            return None
        if isinstance(node, (Filter, Distinct, Slice)):
            return sizes[0]  # upper bound
        if isinstance(node, (GroupBy, Reduce)):
            return max(sizes[0] // 4, 1)
        return sum(sizes)
    return None


def lower_ir_graph(root: IR, config: Optional[LoweringConfig] = None
                   ) -> Tuple[IR, Dict[IR, PartitionInfo]]:
    """Bottom-up rewrite: assign PartitionInfo, insert Shuffle/Repartition,
    and pick broadcast-vs-shuffle joins by the byte budget."""
    cfg = config or LoweringConfig()
    info: Dict[IR, PartitionInfo] = {}
    est_cache: dict = {}  # shared across the whole lowering pass

    def count_for(node: IR) -> int:
        size = _estimate_bytes(node, est_cache)
        if size is None:
            return 1
        return max(1, min(cfg.max_partitions,
                          -(-size // cfg.target_partition_bytes)))

    def reg(node: IR, pi: PartitionInfo) -> IR:
        info[node] = pi
        return node

    def _lower(n: IR, visitor) -> IR:
        kids = [visitor(c) for c in n.children]
        kinfos = [info[k] for k in kids]

        if isinstance(n, (DataFrameScan, Scan, Empty)):
            return reg(n, PartitionInfo(count=count_for(n)))

        if isinstance(n, (Select, HStack, Filter, Projection, MapFunction,
                          Slice, Sink, Cache, Rolling)):
            new = n.reconstruct(kids)
            # NOTE: Slice/Rolling need a global view; single-partition them
            if isinstance(n, (Slice, Rolling)) and kinfos[0].count > 1:
                rep = Repartition(1, children=(kids[0],))
                reg(rep, PartitionInfo(count=1))
                new = n.reconstruct([rep])
                return reg(new, PartitionInfo(count=1))
            return reg(new, kinfos[0])

        if isinstance(n, GroupBy):
            child, ci = kids[0], kinfos[0]
            keys = tuple(n.keys)
            if not keys and ci.count > 1:
                rep = reg(Repartition(1, children=(child,)), PartitionInfo(count=1))
                return reg(n.reconstruct([rep]), PartitionInfo(count=1))
            if ci.count == 1 or ci.partitioned_on == keys:
                return reg(n.reconstruct(kids), ci)
            sh = Shuffle(keys, ci.count, children=(child,))
            reg(sh, PartitionInfo(count=ci.count, partitioned_on=keys))
            return reg(n.reconstruct([sh]),
                       PartitionInfo(count=ci.count, partitioned_on=keys))

        if isinstance(n, Reduce):
            child, ci = kids[0], kinfos[0]
            if ci.count > 1:
                rep = Repartition(1, children=(child,))
                reg(rep, PartitionInfo(count=1))
                return reg(n.reconstruct([rep]), PartitionInfo(count=1))
            return reg(n.reconstruct(kids), PartitionInfo(count=1))

        if isinstance(n, Join):
            lo, ro, how, ne_, suf = n.args
            left, right = kids
            li, ri = kinfos
            rbytes = _estimate_bytes(n.children[1], est_cache)
            # broadcast when the small side fits the budget (reference
            # streaming/join.py:94 _should_bcast_join + legality by type)
            bcast_ok = how in ("inner", "left", "semi", "anti")
            if bcast_ok and rbytes is not None and rbytes <= cfg.broadcast_limit_bytes:
                new = n.reconstruct([left, right])
                return reg(new, li)
            cnt = max(li.count, ri.count)
            lk, rk = tuple(lo), tuple(ro)
            if li.partitioned_on != lk or li.count != cnt:
                left = reg(Shuffle(lk, cnt, children=(left,)),
                           PartitionInfo(count=cnt, partitioned_on=lk))
            if ri.partitioned_on != rk or ri.count != cnt:
                right = reg(Shuffle(rk, cnt, children=(right,)),
                            PartitionInfo(count=cnt, partitioned_on=rk))
            return reg(n.reconstruct([left, right]),
                       PartitionInfo(count=cnt, partitioned_on=lk))

        if isinstance(n, ConditionalJoin):
            # all-pairs predicate: single-partition both sides
            left, right = kids
            outk = []
            for k, ki in zip(kids, kinfos):
                if ki.count > 1:
                    rep = Repartition(1, children=(k,))
                    reg(rep, PartitionInfo(count=1))
                    outk.append(rep)
                else:
                    outk.append(k)
            return reg(n.reconstruct(outk), PartitionInfo(count=1))

        if isinstance(n, Sort):
            child, ci = kids[0], kinfos[0]
            # backends implement global sort natively (range shuffle);
            # partition count is preserved
            return reg(n.reconstruct(kids), PartitionInfo(count=ci.count))

        if isinstance(n, Distinct):
            child, ci = kids[0], kinfos[0]
            subset, keep = n.args
            keys = tuple(subset) if subset is not None else ()
            if ci.count == 1 or (keys and ci.partitioned_on == keys):
                return reg(n.reconstruct(kids), ci)
            if keys:
                sh = reg(Shuffle(keys, ci.count, children=(child,)),
                         PartitionInfo(count=ci.count, partitioned_on=keys))
                return reg(n.reconstruct([sh]),
                           PartitionInfo(count=ci.count, partitioned_on=keys))
            rep = reg(Repartition(1, children=(child,)), PartitionInfo(count=1))
            return reg(n.reconstruct([rep]), PartitionInfo(count=1))

        if isinstance(n, (Union, HConcat, MergeSorted)):
            cnt = sum(ki.count for ki in kinfos) if isinstance(n, Union) else \
                max(ki.count for ki in kinfos)
            if isinstance(n, (HConcat, MergeSorted)):
                # need aligned/global views: single-partition all children
                outk = []
                for k, ki in zip(kids, kinfos):
                    if ki.count > 1:
                        rep = reg(Repartition(1, children=(k,)),
                                  PartitionInfo(count=1))
                        outk.append(rep)
                    else:
                        outk.append(k)
                return reg(n.reconstruct(outk), PartitionInfo(count=1))
            return reg(n.reconstruct(kids), PartitionInfo(count=cnt))

        raise TypeError(f"cannot lower {type(n).__name__}")

    new_root = CachingVisitor(_lower)(root)
    return new_root, info
