"""Async actor-graph streaming executor for the logical IR (counterpart
of ``cudf_tpu/parallel/actor_graph.py``).

The analog of cudf-polars' rapidsmpf actor graph
(streaming/actor_graph/core.py:52,203-300): one coroutine actor per IR
node, joined by channels that carry table chunks, fan-out actors for a
node with several consumers, and a bounded IO budget.

Actors are asyncio tasks in one event loop; channels are bounded
``asyncio.Queue``s (backpressure, the rapidsmpf reservation discipline);
chunk payloads are the port's device Tables, so compute queues on the
device's stream while file IO overlaps through ``asyncio.to_thread``
under an IO semaphore. Chunk by chunk:

* Select/HStack/Filter/Projection/Slice stream chunk to chunk.
* GroupBy aggregates each chunk, then merges the partials n-ary and
  finalizes (``ops/streaming_groupby.py``; variances merge two-pass M2
  states by Chan's formula).
* Join gathers the build (right) side, then streams the probe chunks.
* Sort collects, sorts once and emits chunks again.
* Distinct: a distinct a chunk, then one over their union.

Chunks hold ``target_partition_rows`` rows (``utils/options.py``) unless
the caller gives ``chunk_rows``.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ..core.table import Table
from ..expr.expressions import evaluate as eval_expr
from ..expr.ir import (Cache, DataFrameScan, Distinct, Empty, Filter, GroupBy,
                       HConcat, HStack, IR, Join, Projection, Scan, Select,
                       Sink, Slice, Sort, Union)
from ..ops import copying, join as join_ops, sorting, stream_compaction
from ..ops.streaming_groupby import streaming_groupby
from ..utils.options import get_option

_END = object()


class Channel:
    """Bounded chunk channel with an end-of-stream sentinel."""

    def __init__(self, maxsize: int = 4):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, chunk) -> None:
        await self._q.put(chunk)

    async def close(self) -> None:
        await self._q.put(_END)

    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self._q.get()
        if item is _END:
            raise StopAsyncIteration
        return item


async def _fanout(src: Channel, outs: List[Channel]) -> None:
    """Duplicate a stream to multiple consumers (determine_fanout_nodes)."""
    async for chunk in src:
        for o in outs:
            await o.put(chunk)
    for o in outs:
        await o.close()


def _chunk_table(tbl: Table, rows: int):
    if tbl.num_rows == 0:
        yield tbl
        return
    for s in range(0, tbl.num_rows, rows):
        yield tbl.slice(s, min(rows, tbl.num_rows - s))


class ActorGraphExecutor:
    """Build one actor per IR node and stream chunks through the graph."""

    def __init__(self, chunk_rows: Optional[int] = None, max_io: int = 4):
        self.chunk_rows = chunk_rows or int(get_option("target_partition_rows"))
        self._io_sem = asyncio.Semaphore(max_io)

    # ------------------------------------------------------------- sources
    async def _scan_actor(self, node, out: Channel) -> None:
        if isinstance(node, DataFrameScan):
            for c in _chunk_table(node._tbl, self.chunk_rows):
                await out.put(c)
        else:
            fmt, paths, columns, device = node.args
            from ..io import scan as io_scan

            for path in paths:
                async with self._io_sem:
                    tbl = await asyncio.to_thread(
                        io_scan, fmt, [path],
                        None if columns is None else list(columns), device)
                for c in _chunk_table(tbl, self.chunk_rows):
                    await out.put(c)
        await out.close()

    # ------------------------------------------------------ streaming nodes
    async def _map_actor(self, node, src: Channel, out: Channel) -> None:
        async for chunk in src:
            if isinstance(node, Select):
                res = Table({ne.name: eval_expr(ne.expr, chunk) for ne in node.exprs})
            elif isinstance(node, HStack):
                res = chunk
                for ne in node.exprs:
                    res = res.with_column(ne.name, eval_expr(ne.expr, res))
            elif isinstance(node, Filter):
                mask = eval_expr(node.predicate, chunk)
                res = stream_compaction.apply_boolean_mask(chunk, mask)
            elif isinstance(node, Projection):
                res = chunk.select(list(node.args[0]))
            else:
                raise TypeError(node)
            await out.put(res)
        await out.close()

    async def _groupby_actor(self, node: GroupBy, src: Channel, out: Channel) -> None:
        from ..expr.ir import _groupby_via_specs
        from ..ops.groupby import AggSpec
        from ..expr.expressions import Agg, Col, Len

        parts: List[Table] = []
        specs: List[AggSpec] = []
        pre_cols: Dict[str, object] = {}
        for ne in node.agg_exprs:
            e = ne.expr
            if isinstance(e, Agg) and isinstance(e.children[0], Col):
                specs.append(AggSpec(e.children[0].name, e.kind, ne.name, e.param or 0.0))
            elif isinstance(e, Len):
                specs.append(AggSpec("", "size", ne.name))
            else:
                specs = None
                break
        if specs is None:
            # complex pre-agg expressions: collect then single-shot groupby
            chunks = [c async for c in src]
            res = _groupby_via_specs(copying.concatenate_tables(chunks),
                                     node.keys, node.agg_exprs)
            await out.put(res)
            await out.close()
            return
        async for chunk in src:
            parts.append(chunk)
        res = streaming_groupby(parts, list(node.keys), specs)
        res = res.select(list(node.keys) + [ne.name for ne in node.agg_exprs])
        await out.put(res)
        await out.close()

    async def _join_actor(self, node: Join, left: Channel, right: Channel,
                          out: Channel) -> None:
        lo, ro, how, ne_, suf = node.args
        build_chunks = [c async for c in right]
        build = copying.concatenate_tables(build_chunks) if build_chunks else Table({})
        # broadcast-join: stream probe chunks against the gathered build side
        async for chunk in left:
            res = join_ops.join(chunk, build, list(lo), list(ro), how,
                                ne_, suf)
            await out.put(res)
        await out.close()

    async def _sort_actor(self, node: Sort, src: Channel, out: Channel) -> None:
        chunks = [c async for c in src]
        whole = copying.concatenate_tables(chunks) if chunks else Table({})
        by, desc, nl = node.args
        res = sorting.sort_by_key(whole, list(by), list(desc), list(nl))
        for c in _chunk_table(res, self.chunk_rows):
            await out.put(c)
        await out.close()

    async def _distinct_actor(self, node: Distinct, src: Channel, out: Channel) -> None:
        subset, keep = node.args
        partials = []
        async for chunk in src:
            partials.append(stream_compaction.distinct(
                chunk, None if subset is None else list(subset), keep))
        whole = copying.concatenate_tables(partials) if partials else Table({})
        res = stream_compaction.distinct(
            whole, None if subset is None else list(subset), keep)
        await out.put(res)
        await out.close()

    async def _union_actor(self, srcs: List[Channel], out: Channel) -> None:
        for s in srcs:
            async for chunk in s:
                await out.put(chunk)
        await out.close()

    async def _slice_actor(self, node: Slice, src: Channel, out: Channel) -> None:
        offset, length = node.args[0], node.args[1]
        remaining_skip, remaining = offset, length
        async for chunk in src:
            n = chunk.num_rows
            if remaining <= 0:
                continue
            if remaining_skip >= n:
                remaining_skip -= n
                continue
            take = min(n - remaining_skip, remaining)
            await out.put(chunk.slice(remaining_skip, take))
            remaining_skip = 0
            remaining -= take
        await out.close()

    async def _sink_actor(self, node: Sink, src: Channel, out: Channel) -> None:
        chunks = [c async for c in src]
        whole = copying.concatenate_tables(chunks) if chunks else Table({})
        from ..io import write as io_write

        await asyncio.to_thread(io_write, whole, node.args[0], node.args[1])
        await out.put(whole)
        await out.close()

    # ------------------------------------------------------------- plumbing
    def _build(self, node: IR, tasks: list, consumers: Dict[int, List[Channel]],
               built: Dict[int, Channel]) -> Channel:
        """Wire actors bottom-up; multi-consumer nodes get a fanout actor."""
        key = id(node)
        if key in built:
            # second consumer: attach to the fanout
            ch = Channel()
            consumers[key].append(ch)
            return ch
        if isinstance(node, (DataFrameScan, Scan)):
            out = Channel()
            tasks.append(self._scan_actor(node, out))
        elif isinstance(node, (Select, HStack, Filter, Projection)):
            src = self._build(node.children[0], tasks, consumers, built)
            out = Channel()
            tasks.append(self._map_actor(node, src, out))
        elif isinstance(node, GroupBy):
            src = self._build(node.children[0], tasks, consumers, built)
            out = Channel()
            tasks.append(self._groupby_actor(node, src, out))
        elif isinstance(node, Join):
            l = self._build(node.children[0], tasks, consumers, built)
            r = self._build(node.children[1], tasks, consumers, built)
            out = Channel()
            tasks.append(self._join_actor(node, l, r, out))
        elif isinstance(node, Sort):
            src = self._build(node.children[0], tasks, consumers, built)
            out = Channel()
            tasks.append(self._sort_actor(node, src, out))
        elif isinstance(node, Distinct):
            src = self._build(node.children[0], tasks, consumers, built)
            out = Channel()
            tasks.append(self._distinct_actor(node, src, out))
        elif isinstance(node, Union):
            srcs = [self._build(c, tasks, consumers, built) for c in node.children]
            out = Channel()
            tasks.append(self._union_actor(srcs, out))
        elif isinstance(node, Slice):
            src = self._build(node.children[0], tasks, consumers, built)
            out = Channel()
            tasks.append(self._slice_actor(node, src, out))
        elif isinstance(node, Sink):
            src = self._build(node.children[0], tasks, consumers, built)
            out = Channel()
            tasks.append(self._sink_actor(node, src, out))
        elif isinstance(node, Cache):
            return self._build(node.children[0], tasks, consumers, built)
        elif isinstance(node, Empty):
            out = Channel()

            async def _empty(o=out):
                await o.put(Table({}))
                await o.close()

            tasks.append(_empty())
        elif isinstance(node, HConcat):
            # align chunk streams positionally; simplest: collect both
            srcs = [self._build(c, tasks, consumers, built) for c in node.children]
            out = Channel()

            async def _hconcat(ss=srcs, o=out):
                tables = []
                for s in ss:
                    chunks = [c async for c in s]
                    tables.append(copying.concatenate_tables(chunks))
                cols = {}
                for t in tables:
                    for name, c in t:
                        cols[name] = c
                await o.put(Table(cols))
                await o.close()

            tasks.append(_hconcat())
        else:
            raise TypeError(f"actor graph cannot execute {type(node).__name__}")
        # register a fanout in case more consumers show up
        first = Channel()
        consumers[key] = [first]
        built[key] = out
        tasks.append(_fanout(out, consumers[key]))
        return first

    async def _run(self, node: IR) -> Table:
        tasks: list = []
        consumers: Dict[int, List[Channel]] = {}
        built: Dict[int, Channel] = {}
        final = self._build(node, tasks, consumers, built)
        running = [asyncio.create_task(t) for t in tasks]
        chunks = [c async for c in final]
        await asyncio.gather(*running)
        return copying.concatenate_tables(chunks) if chunks else Table({})

    def execute(self, node: IR) -> Table:
        """Run the IR dag as a streaming actor graph; returns the result."""
        return asyncio.run(self._run(node))


def execute_streaming(node: IR, chunk_rows: Optional[int] = None) -> Table:
    """One-call streaming execution (evaluate_logical_plan analog)."""
    return ActorGraphExecutor(chunk_rows=chunk_rows).execute(node)
