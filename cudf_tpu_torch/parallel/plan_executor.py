"""The lowered-plan executor (counterpart of
``cudf_tpu/parallel/plan_executor.py:34-159``).

One logical IR (``expr/ir.py``) and one lowering pass (``expr/lowering.py``)
drive the engines, the reference's executor architecture (cudf-polars
utils/config.py:804, in-memory or streaming):

  execute              in memory (``expr/ir.py``; Shuffle and Repartition
                       are no-ops)
  execute_partitioned  the lowered plan, each node a list of partitions

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
passes every key's flags to the port's ``sort_values``. ``execute_spmd``
(a device mesh) waits for the distributed slice.
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


def execute_spmd(root: IRM.IR, *args, **kwargs):
    """The device-mesh engine: not ported yet."""
    raise NotImplementedError("execute_spmd is not ported yet (ROADMAP queue 1, "
                              "distributed: parallel/spmd.py)")
