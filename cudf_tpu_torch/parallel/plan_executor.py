"""The lowered-plan executor (counterpart of
``cudf_tpu/parallel/plan_executor.py:34-159``).

One logical IR (``expr/ir.py``) and one lowering pass (``expr/lowering.py``)
drive the engines, the reference's executor architecture (cudf-polars
utils/config.py:804, in-memory or streaming):

  execute              in memory (``expr/ir.py``; Shuffle and Repartition
                       are no-ops)
  execute_partitioned  the lowered plan, each node a list of partitions
  execute_spmd         a mesh of shards, exchanges through a communicator

A ``Shuffle`` hash-splits every partition by its keys' murmur3 row hash
(``ops/hashing.partition_ids``, bit-equal to the reference's; the
reference's partition_and_pack + shuffler, cpp/libcudf_streaming/src/
partition_utils.cpp) over the keys made independent of their table
(``_shuffle_key``: a string hashed by value, not by its dictionary code,
and no validity word), so equal keys of two tables meet; co-partitioned joins and groupbys then run partition
by partition, and a join the lowering made a broadcast joins each left
partition with the whole right side. The partitions stay on the device, as
in the reference; the spilling ``PartitionedFrame`` is the other engine.

Faults of the reference not copied (each pinned by a test): its ``Shuffle``
drops empty buckets, so the two sides of a join can come back with
different partition counts (an AssertionError); its ``Sort`` over several
partitions passes only the first key's ``descending`` flag and its
``PartitionedFrame.sort_values`` orders buckets ascending whatever the
flags. Here a Shuffle returns exactly ``count`` partitions, and a Sort
passes every key's flags to the port's ``sort_values``.

``execute_spmd`` runs the plan (not lowered) over a mesh of shards
(``parallel/spmd.py``): the distributed ops exchange rows themselves, so
the lowering's Shuffle nodes are not needed.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..core import dtypes
from ..core.dtypes import Kind
from ..core.column import Column, resolve_device
from ..core.table import Table
from ..expr import ir as IRM
from ..expr.lowering import LoweringConfig, lower_ir_graph
from ..expr.nodebase import CachingVisitor


def _split_rows(tbl: Table, count: int) -> List[Table]:
    """At most ``count`` contiguous row slices of ``tbl``."""
    if count <= 1 or tbl.num_rows == 0:
        return [tbl]
    n = tbl.num_rows
    step = math.ceil(n / count)
    return [tbl.slice(i * step, min(step, n - i * step))
            for i in range(count) if i * step < n]


def _shuffle_key(col: Column) -> Column:
    """``col`` as a Shuffle hashes it, so that one value hashes alike in
    every table: the two sides of a join are different tables. A string's
    code indexes its own table's dictionary, so it is replaced by a hash
    of its value; integers and booleans widen to int64 and f32 to f64; a
    null reads as 0 and the validity mask goes, since one side may have a
    mask and the other none (a null then shares a bucket with 0, which
    changes no answer). A non-null int64 or f64 key is left as it is, and
    hashes to the reference's bucket."""
    import torch

    from ..utils.real_pandas import pd

    data, dt = col.data, col.dtype
    if dt.is_string:
        values = col.dictionary if col.dictionary is not None else np.array([], dtype=str)
        words = pd.util.hash_array(np.asarray(values, dtype=object)).view(np.int64)
        table = torch.from_numpy(np.append(words, 0)).to(data.device)
        data, dt = table[data.to(torch.int64).clamp(0, len(values))], dtypes.int64
    elif dt.kind in (Kind.INT, Kind.UINT, Kind.BOOL) and dt.bits < 64:
        data, dt = data.to(torch.int64), dtypes.int64
    elif dt.kind == Kind.FLOAT and dt.bits < 64:
        data, dt = data.to(torch.float64), dtypes.float64
    if col.validity is not None:
        data = torch.where(col.validity, data, torch.zeros((), dtype=data.dtype,
                                                           device=data.device))
    return Column(dt, data, None, col.length)


def _hash_split(tbl: Table, keys: List[str], count: int) -> List[Table]:
    """``count`` tables: the rows of ``tbl`` whose keys hash to each bucket,
    in row order (empty buckets included)."""
    from ..ops.hashing import partition_ids
    from ..ops.stream_compaction import apply_boolean_mask

    if count <= 1:
        return [tbl]
    pid = partition_ids([_shuffle_key(tbl[k]) for k in keys], count)
    return [apply_boolean_mask(tbl, Column(dtypes.bool_, pid == p, None, tbl.num_rows))
            for p in range(count)]


def _concat(tables: List[Table]) -> Table:
    from ..ops.copying import concatenate_tables

    return concatenate_tables(tables) if len(tables) > 1 else tables[0]


def execute_partitioned(root: IRM.IR, config: Optional[LoweringConfig] = None,
                        collect: bool = True, device=None):
    """Run the lowered plan of ``root`` partition by partition; the result
    as one table (``collect``) or as its list of partitions. ``device``
    (default CUDA) is where a multi-partition sort's frame lives."""
    from .partitioned import PartitionedFrame

    dev = resolve_device(device)
    plan, info = lower_ir_graph(root, config)

    def _local(n: IRM.IR, tables: List[Table]) -> Table:
        """One node over materialized child tables, by the in-memory
        executor's own dispatch."""
        return IRM.execute(n.reconstruct([IRM.DataFrameScan(t) for t in tables]))

    def _exec(n: IRM.IR, visitor) -> List[Table]:
        if isinstance(n, IRM.DataFrameScan):
            return _split_rows(n._tbl, info[n].count)
        if isinstance(n, IRM.Scan):
            from ..io import scan as io_scan

            fmt, paths, columns, scan_device = n.args
            t = io_scan(fmt, list(paths), None if columns is None else list(columns),
                        device=scan_device)
            return _split_rows(t, info[n].count)
        if isinstance(n, IRM.Shuffle):
            kids = visitor(n.children[0])
            keys, count = list(n.args[0]), n.args[1]
            buckets: List[List[Table]] = [[] for _ in range(count)]
            for t in kids:
                for p, sub in enumerate(_hash_split(t, keys, count)):
                    buckets[p].append(sub)
            return [_concat(b) for b in buckets]
        if isinstance(n, IRM.Repartition):
            return _split_rows(_concat(visitor(n.children[0])), n.args[0])
        if isinstance(n, (IRM.Select, IRM.HStack, IRM.Filter, IRM.Projection,
                          IRM.MapFunction, IRM.Distinct, IRM.GroupBy)):
            # partition-wise exact: the lowering co-partitioned the input
            return [_local(n, [t]) for t in visitor(n.children[0])]
        if isinstance(n, IRM.Join):
            lo, ro = n.args[0], n.args[1]
            lparts = visitor(n.children[0])
            rparts = visitor(n.children[1])
            li, ri = info[n.children[0]], info[n.children[1]]
            if (li.partitioned_on == tuple(lo) and ri.partitioned_on == tuple(ro)
                    and len(lparts) == len(rparts)):
                return [_local(n, [lt, rt]) for lt, rt in zip(lparts, rparts)]
            # a broadcast join (the lowering shuffles every other join): the
            # whole right side against each left partition
            right = _concat(rparts)
            return [_local(n, [lt, right]) for lt in lparts]
        if isinstance(n, IRM.Sort):
            kids = visitor(n.children[0])
            by, desc, nl = n.args
            if len(kids) > 1:
                pf = PartitionedFrame.from_tables(kids, spill=False, device=dev)
                return [p.get() for p in pf.sort_values(list(by), list(desc), list(nl))._parts]
            from ..ops.sorting import sort_by_key

            return [sort_by_key(kids[0], list(by), list(desc), list(nl))]
        if isinstance(n, IRM.Union):
            return [t for c in n.children for t in visitor(c)]
        if isinstance(n, (IRM.Reduce, IRM.Slice, IRM.HConcat, IRM.MergeSorted,
                          IRM.ConditionalJoin, IRM.Rolling, IRM.Sink, IRM.Empty)):
            return [_local(n, [_concat(visitor(c)) for c in n.children])]
        if isinstance(n, IRM.Cache):
            return visitor(n.children[0])
        raise TypeError(f"partitioned engine cannot execute {type(n).__name__}")

    parts = CachingVisitor(_exec)(plan)
    if not collect:
        return parts
    return _concat(parts)


def execute_spmd(root: IRM.IR, mesh=None, axis: str = "shards") -> Table:
    """Run ``root`` over a mesh of shards (``parallel/spmd.py``), the
    reference's node mapping:

      Scan, DataFrameScan      -> rows split into one slice a shard
      Select/HStack/Filter/
      Projection               -> ``spmd.dist_elementwise`` on each shard
      MapFunction              -> the in-memory executor on each shard
      Distinct                 -> ``spmd.dist_distinct``
      GroupBy                  -> ``spmd.dist_groupby`` (null keys dropped,
                                  as in memory) when every agg is a column's
                                  agg or a count and there are keys; else
                                  gathered and run in memory
      Join                     -> ``spmd.broadcast_join`` when the right side
                                  fits ``broadcast_limit_bytes`` (inner,
                                  left), ``spmd.dist_semi_anti_join`` with
                                  that side broadcast (semi, anti), else
                                  ``spmd.dist_join``
      Sort                     -> ``spmd.dist_sort_values`` with every key's
                                  flags
      Shuffle, Repartition,
      Cache                    -> nothing: the dist ops exchange themselves
      anything else            -> gathered to one table and run in memory

    ``mesh`` defaults to one shard a CUDA device."""
    from ..expr.expressions import Agg, Col, Len
    from ..expr.lowering import _estimate_bytes
    from ..ops.groupby import AggSpec
    from . import spmd

    if mesh is None:
        mesh = spmd.make_mesh(axis=axis)
    n = mesh.size
    cfg = LoweringConfig()

    def to_sharded(t: Table) -> spmd.ShardedTable:
        parts = _split_rows(t, n)
        while len(parts) < n:
            parts.append(t.slice(0, 0))
        return spmd.ShardedTable.from_tables(parts, mesh, axis)

    def gathered(x) -> Table:
        return x if isinstance(x, Table) else x.concat_to_table()

    def _local(node: IRM.IR, tables: List[Table]) -> Table:
        return IRM.execute(node.reconstruct([IRM.DataFrameScan(t) for t in tables]))

    def _exec(node: IRM.IR, visitor):
        # a ShardedTable for sharded stages, a Table for global ones
        if isinstance(node, IRM.DataFrameScan):
            return to_sharded(node._tbl)
        if isinstance(node, IRM.Scan):
            from ..io import scan as io_scan

            fmt, paths, columns, scan_device = node.args
            return to_sharded(io_scan(fmt, list(paths),
                                      None if columns is None else list(columns),
                                      device=scan_device))
        if isinstance(node, (IRM.Select, IRM.HStack, IRM.Filter, IRM.Projection,
                             IRM.MapFunction, IRM.Distinct)):
            child = visitor(node.children[0])
            if isinstance(child, Table):
                return _local(node, [child])
            if isinstance(node, IRM.Distinct):
                subset, keep = node.args
                return spmd.dist_distinct(child, subset, keep)
            if isinstance(node, IRM.MapFunction):
                return spmd._local(child, lambda t: _local(node, [t]))
            return spmd.dist_elementwise(child, node)
        if isinstance(node, IRM.GroupBy):
            child = visitor(node.children[0])
            if isinstance(child, Table):
                return _local(node, [child])
            specs = []
            for ne in node.agg_exprs:
                e = ne.expr
                if isinstance(e, Agg) and isinstance(e.children[0], Col):
                    specs.append(AggSpec(e.children[0].name, e.kind, ne.name,
                                         e.param or 0.0))
                elif isinstance(e, Len):
                    specs.append(AggSpec("", "size", ne.name))
                else:
                    specs = None
                    break
            if specs is None or not node.keys:
                return _local(node, [child.concat_to_table()])
            return spmd.dist_groupby(child, list(node.keys), specs, dropna_keys=True)
        if isinstance(node, IRM.Join):
            lo, ro, how = node.args[0], node.args[1], node.args[2]
            left = visitor(node.children[0])
            right = visitor(node.children[1])
            if isinstance(left, Table) and isinstance(right, Table):
                return _local(node, [left, right])
            if isinstance(left, Table):
                left = to_sharded(left)
            rbytes = _estimate_bytes(node.children[1])
            small_right = rbytes is not None and rbytes <= cfg.broadcast_limit_bytes
            if small_right and how in ("inner", "left"):
                return spmd.broadcast_join(left, gathered(right), list(lo), list(ro), how)
            if small_right and how in ("semi", "anti"):
                return spmd.dist_semi_anti_join(left, None, list(lo), list(ro), how,
                                                broadcast_right=gathered(right))
            if isinstance(right, Table):
                right = to_sharded(right)
            return spmd.dist_join(left, right, list(lo), list(ro), how)
        if isinstance(node, IRM.Sort):
            child = visitor(node.children[0])
            by, desc, nl = node.args
            if isinstance(child, Table):
                return _local(node, [child])
            return spmd.dist_sort_values(child, list(by), list(desc), list(nl))
        if isinstance(node, (IRM.Shuffle, IRM.Repartition, IRM.Cache)):
            return visitor(node.children[0])
        # global stages (Union included): gather and run in memory
        return _local(node, [gathered(visitor(c)) for c in node.children])

    return gathered(CachingVisitor(_exec)(root))
