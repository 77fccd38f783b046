"""The multi-process plan executor: one lowered IR, every process a rank
(counterpart of ``cudf_tpu/parallel/multiproc_stream.py``).

The multi-controller analog of the reference's streaming executor, whose
IR nodes each become a task sub-network per rank with buffered
rank-to-rank shuffles (libcudf_streaming actor_graph/core.py:203-300).
Here:

- every rank walks the same lowered plan, so the exchanges happen in the
  same order everywhere;
- each rank owns a slice of every scan and runs the elementwise stages on
  its own partitions;
- a ``Shuffle`` sends each row to the rank its keys hash to, through
  ``multihost.host_exchange`` (addressed blobs, O(bytes sent)), then
  re-splits the rank's rows into the lowered partition count;
- broadcast and global stages replicate through the same exchange; so
  does a GroupBy or Distinct the lowering left in one partition (it
  inserted no Shuffle, but the scan split the rows over the ranks: the
  reference groups each rank's rows apart and returns a group once a
  rank);
- a ``Sort`` is a sample sort on the order words of ``spmd``: the global
  key stats and every rank's samples replicate, the splitters cut the
  word space, rows go to the rank of their range and each rank sorts its
  own, so rank order is global order for every key's flags (a string key
  replicates the table and each rank keeps its slice of the sorted rows).

A single process runs ``execute_partitioned``, as the reference's walk
reduces to it.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.table import Table
from ..expr import ir as IRM
from ..expr.lowering import LoweringConfig, lower_ir_graph
from ..expr.nodebase import CachingVisitor
from . import multihost
from .plan_executor import _concat, _hash_split, _split_rows, execute_partitioned

SORT_SAMPLES = 128  # samples a rank gives the sort's splitters (spmd's default)


def _me() -> int:
    return multihost.process_index()


def _nproc() -> int:
    return multihost.process_count()


def _replicate(tbl: Table) -> Table:
    """Every rank's piece, concatenated in rank order, on every rank."""
    if _nproc() == 1:
        return tbl
    return _concat(multihost.host_exchange([tbl] * _nproc()))


def _exchange(parts_by_rank: List[Table]) -> Table:
    if _nproc() == 1:
        return parts_by_rank[0]
    return _concat(multihost.host_exchange(parts_by_rank))


def _host_table(values: dict, device) -> Table:
    import numpy as np

    return Table.from_pydict({k: np.asarray(v) for k, v in values.items()}, device=device)


def _global_sort_stats(merged: Table, by: List[str]):
    """Each key's ColStats over every rank, and whether any rank masks it."""
    from .spmd import _shard_stats, stats_of

    cols = {}
    for i, k in enumerate(by):
        for j, v in enumerate(_shard_stats(merged[k])):
            cols[f"{i}_{j}"] = [v]
        cols[f"{i}_m"] = [float(merged[k].validity is not None)]
    every = _replicate(_host_table(cols, merged.device)).to_pandas()
    stats = [stats_of(every[f"{i}_0"].min(), every[f"{i}_1"].max(), every[f"{i}_2"].sum(),
                      *(every[f"{i}_{j}"].max() for j in (3, 4, 5)))
             for i in range(len(by))]
    return stats, [bool(every[f"{i}_m"].max()) for i in range(len(by))]


def _sample_sort(merged: Table, by: List[str], desc, nl) -> Table:
    """This rank's range of the global order of every rank's ``merged``."""
    from ..core import dtypes
    from ..core.column import Column
    from ..ops.sorting import sort_by_key
    from ..ops.stream_compaction import apply_boolean_mask
    from . import spmd

    nproc, me = _nproc(), _me()
    if any(merged[k].dtype.is_string for k in by):
        # codes of different ranks index different dictionaries: sort the
        # whole table on every rank and keep this rank's slice
        s = sort_by_key(_replicate(merged), by, desc, nl)
        return _split_rows(s, nproc)[me] if s.num_rows else s
    stats, masked = _global_sort_stats(merged, by)
    plan = spmd.sort_plan([merged[k].dtype for k in by], masked, stats)
    words = spmd.order_words(merged, by, plan, stats, masked, desc, nl)
    samp = spmd.shard_samples(words[0], merged.num_rows, SORT_SAMPLES)
    allsamp = _replicate(_host_table({"w": samp.cpu().numpy()}, merged.device))["w"]
    splitters = spmd.splitters_of(allsamp.data[: allsamp.length], nproc)
    n = merged.num_rows
    pid = torch.searchsorted(splitters.to(words[0].device), words[0][:n], right=True)
    pid = torch.cat([pid, pid.new_full((merged[by[0]].capacity - n,), -1)])
    sends = [apply_boolean_mask(merged, Column(dtypes.bool_, pid == r, None, n))
             for r in range(nproc)]
    return sort_by_key(_exchange(sends), by, desc, nl)


def execute_multiproc(root: IRM.IR, config: Optional[LoweringConfig] = None,
                      collect: str = "local", device=None):
    """Run the lowered plan of ``root`` across every process.

    ``collect``: "local" returns this rank's slice of the result, "global"
    the whole result on every rank. A single process runs
    ``execute_partitioned(root, config, device=device)``."""
    nproc, me = _nproc(), _me()
    if nproc == 1:
        return execute_partitioned(root, config, device=device)
    plan, info = lower_ir_graph(root, config)

    def _rank_count(n: IRM.IR) -> int:
        # the lowered global count divided over the ranks (>= 1, so every
        # rank walks the same schedule)
        return max(1, info[n].count // nproc)

    def _local(n: IRM.IR, tables: List[Table]) -> Table:
        return IRM.execute(n.reconstruct([IRM.DataFrameScan(t) for t in tables]))

    def _exec(n: IRM.IR, visitor) -> List[Table]:
        def _global(n: IRM.IR) -> List[Table]:
            """Replicate the inputs, compute on every rank (the same answer
            everywhere), keep this rank's slice."""
            full = _local(n, [_replicate(_concat(visitor(c))) for c in n.children])
            parts = _split_rows(full, nproc)
            return [parts[me] if me < len(parts) else full.slice(0, 0)]

        if isinstance(n, IRM.DataFrameScan):
            mine = _split_rows(n._tbl, nproc)
            mine = mine[me] if me < len(mine) else n._tbl.slice(0, 0)
            return _split_rows(mine, _rank_count(n))
        if isinstance(n, IRM.Scan):
            from ..io import scan as io_scan

            fmt, paths, columns, scan_device = n.args
            paths = list(paths)
            cols = None if columns is None else list(columns)
            if len(paths) >= nproc:
                t = io_scan(fmt, [p for i, p in enumerate(paths) if i % nproc == me], cols,
                            device=scan_device)
                return _split_rows(t, _rank_count(n))
            t = io_scan(fmt, paths, cols, device=scan_device)
            mine = _split_rows(t, nproc)
            mine = mine[me] if me < len(mine) else t.slice(0, 0)
            return _split_rows(mine, _rank_count(n))
        if isinstance(n, IRM.Shuffle):
            kids = visitor(n.children[0])
            keys = list(n.args[0])
            # the owner rank is hash % nproc, as the partitioned Shuffle hashes
            by_rank: List[List[Table]] = [[] for _ in range(nproc)]
            for t in kids:
                for r, sub in enumerate(_hash_split(t, keys, nproc)):
                    by_rank[r].append(sub)
            mine = _exchange([_concat(b) for b in by_rank])
            return _hash_split(mine, keys, _rank_count(n))
        if isinstance(n, IRM.Repartition):
            return _split_rows(_concat(visitor(n.children[0])), _rank_count(n))
        if isinstance(n, (IRM.Distinct, IRM.GroupBy)) and info[n].count == 1:
            # the lowering saw one partition and shuffled nothing, but the
            # scan split it over the ranks: a global stage
            return _global(n)
        if isinstance(n, (IRM.Select, IRM.HStack, IRM.Filter, IRM.Projection,
                          IRM.MapFunction, IRM.Distinct, IRM.GroupBy)):
            return [_local(n, [t]) for t in visitor(n.children[0])]
        if isinstance(n, IRM.Join):
            lparts = visitor(n.children[0])
            rparts = visitor(n.children[1])
            if info[n.children[1]].count == 1:
                # a broadcast join: the small side replicated to every rank
                rfull = _replicate(_concat(rparts))
                return [_local(n, [t, rfull]) for t in lparts]
            assert len(lparts) == len(rparts), "join sides not co-partitioned"
            return [_local(n, [lt, rt]) for lt, rt in zip(lparts, rparts)]
        if isinstance(n, IRM.Sort):
            by, desc, nl = n.args
            return [_sample_sort(_concat(visitor(n.children[0])), list(by), list(desc),
                                 list(nl))]
        if isinstance(n, IRM.Union):
            return [t for c in n.children for t in visitor(c)]
        if isinstance(n, (IRM.Reduce, IRM.Slice, IRM.HConcat, IRM.MergeSorted,
                          IRM.ConditionalJoin, IRM.Rolling, IRM.Sink, IRM.Empty)):
            return _global(n)
        if isinstance(n, IRM.Cache):
            return visitor(n.children[0])
        raise TypeError(f"multiproc engine cannot execute {type(n).__name__}")

    local = _concat(CachingVisitor(_exec)(plan))
    return _replicate(local) if collect == "global" else local
