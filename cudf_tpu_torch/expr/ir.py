"""Logical plan IR + in-memory executor (counterpart of
``cudf_tpu/expr/ir.py``).

Analog of cudf-polars' IR (reference: python/cudf_polars/cudf_polars/dsl/
ir.py — Scan:418, DataFrameScan:1311, Select:1437, GroupBy:1778, Join:2224,
HStack:2633, Distinct:2686, Sort:2781, Slice:2864, Filter:2892, Union:3200,
HConcat:3242) with the same evaluate-recursion shape (ir.py:254-300). The
node classes, the projection pushdown (``scan_column_requirements``) and the
executor's dispatch are the reference's. Differences:

  * a pruned ``Filter`` compacts only the columns its parent needs: the
    reference compacts every column and drops the predicate-only ones
    after; the result is the same table;
  * joins pass ``ordered=False``, as the reference's executor does, so an
    inner join builds its hash table on the smaller side (``ops/join.py``);
  * the projection pushdown reaches file scans too: a ``Scan`` gives its
    parent only the columns the plan reads, and since a parquet scan's
    columns are deferred (``io.read_parquet``), the others are never read
    from disk. The reference prunes only in-memory scans; the result is
    the same table;
  * nodes whose ops are not ported yet raise ``NotImplementedError`` and
    name their ROADMAP queue-1 item: ``ConditionalJoin`` (8) and
    ``MapFunction`` explode (14).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from ..core.table import Table
from ..ops import copying, join as join_ops, sorting, stream_compaction
from ..ops.groupby import AggSpec, groupby_aggregate
from .expressions import Agg, Col, Expr, Len, NamedExpr, evaluate
from .nodebase import CachingVisitor, Node


class IR(Node):
    """Base logical plan node."""


def _pack_exprs(exprs):
    """(name, expr) pairs from NamedExprs OR already-packed pairs — keeps
    Node.reconstruct (which replays raw args) working."""
    return tuple(
        (e.name, e.expr) if isinstance(e, NamedExpr) else (e[0], e[1])
        for e in exprs
    )


class DataFrameScan(IR):
    """Wrap an in-memory Table."""

    def __init__(self, tbl: Table, children=()):
        super().__init__(id(tbl))
        object.__setattr__(self, "_tbl", tbl)

    __slots__ = ("_tbl",)

    def _key(self):
        return (type(self), self.args)


class Scan(IR):
    """File scan: (fmt, paths, columns), on the default device (CUDA)."""

    def __init__(self, fmt: str, paths: tuple, columns: Optional[tuple] = None,
                 device=None, children=()):
        super().__init__(fmt, tuple(paths), None if columns is None else tuple(columns),
                         None if device is None else str(device))


class Select(IR):
    def __init__(self, exprs: Tuple[NamedExpr, ...], children=()):
        super().__init__(_pack_exprs(exprs), children=children)

    @property
    def exprs(self):
        return [NamedExpr(n, e) for n, e in self.args[0]]


class HStack(IR):
    """with_columns: add/replace columns."""

    def __init__(self, exprs: Tuple[NamedExpr, ...], children=()):
        super().__init__(_pack_exprs(exprs), children=children)

    @property
    def exprs(self):
        return [NamedExpr(n, e) for n, e in self.args[0]]


class Filter(IR):
    def __init__(self, predicate: Expr, children=()):
        super().__init__(predicate, children=children)

    @property
    def predicate(self):
        return self.args[0]


class GroupBy(IR):
    def __init__(self, keys: tuple, aggs: Tuple[NamedExpr, ...], children=()):
        super().__init__(tuple(keys), _pack_exprs(aggs), children=children)

    @property
    def keys(self):
        return list(self.args[0])

    @property
    def agg_exprs(self):
        return [NamedExpr(n, e) for n, e in self.args[1]]


class Join(IR):
    def __init__(self, left_on: tuple, right_on: tuple, how: str,
                 nulls_equal: bool = False, suffixes=("_x", "_y"), children=()):
        super().__init__(tuple(left_on), tuple(right_on), how, nulls_equal,
                         tuple(suffixes), children=children)


class Sort(IR):
    def __init__(self, by: tuple, descending: tuple, nulls_last: tuple, children=()):
        super().__init__(tuple(by), tuple(descending), tuple(nulls_last),
                         children=children)


class Distinct(IR):
    def __init__(self, subset: Optional[tuple], keep: str = "first", children=()):
        super().__init__(None if subset is None else tuple(subset), keep,
                         children=children)


class Slice(IR):
    def __init__(self, offset: int, length: Optional[int], children=()):
        super().__init__(offset, length, children=children)


class Union(IR):
    def __init__(self, children=()):
        super().__init__(children=children)


class HConcat(IR):
    def __init__(self, children=()):
        super().__init__(children=children)


class Projection(IR):
    def __init__(self, columns: tuple, children=()):
        super().__init__(tuple(columns), children=children)


class Empty(IR):
    def __init__(self, children=()):
        super().__init__()


class Sink(IR):
    """Write result to a file (fmt, path)."""

    def __init__(self, fmt: str, path: str, children=()):
        super().__init__(fmt, path, children=children)


class Cache(IR):
    def __init__(self, key: int, children=()):
        super().__init__(key, children=children)


class Reduce(IR):
    """Whole-frame reductions -> 1-row table (reference dsl/ir.py:1552)."""

    def __init__(self, exprs: Tuple[NamedExpr, ...], children=()):
        super().__init__(_pack_exprs(exprs), children=children)

    @property
    def exprs(self):
        return [NamedExpr(n, e) for n, e in self.args[0]]


class Rolling(IR):
    """Rolling-window aggregation over an orderby column (reference
    dsl/ir.py:1589). aggs: (out_name, value_col, kind) triples; window is a
    row count (int) or a range width on the orderby values."""

    def __init__(self, orderby: str, window, aggs: tuple, range_based: bool = False,
                 children=()):
        super().__init__(orderby, window, tuple(aggs), range_based,
                         children=children)


class ConditionalJoin(IR):
    """Join on an arbitrary row-pair predicate (reference dsl/ir.py:2093).

    predicate: an Expr over the cross-product frame (left columns keep their
    names, right columns suffixed when clashing)."""

    def __init__(self, predicate: Expr, how: str = "inner", children=()):
        super().__init__(predicate, how, children=children)


class MergeSorted(IR):
    """k-way merge of already-sorted inputs on a key (reference
    dsl/ir.py:2948)."""

    def __init__(self, key: str, children=()):
        super().__init__(key, children=children)


class MapFunction(IR):
    """Named whole-table transform (reference dsl/ir.py:2999): rename,
    explode, row_index, ..."""

    def __init__(self, name: str, options: tuple = (), children=()):
        super().__init__(name, tuple(options), children=children)


class Shuffle(IR):
    """Hash-repartition rows by key columns (reference streaming/shuffle.py:25).
    Inserted by lowering; a no-op for the in-memory executor."""

    def __init__(self, keys: tuple, count: int, children=()):
        super().__init__(tuple(keys), count, children=children)

    @property
    def keys(self):
        return list(self.args[0])


class Repartition(IR):
    """Change partition count without a key (reference streaming
    Repartition)."""

    def __init__(self, count: int, children=()):
        super().__init__(count, children=children)


# ---------------------------------------------------------------------------
def _groupby_via_specs(tbl: Table, keys: List[str], agg_exprs: List[NamedExpr]) -> Table:
    """Lower groupby agg expressions to AggSpecs, pre-materializing inputs.

    ``Agg(sum, child)`` — child may be any expression: materialize it into a
    temp column first (cuDF evaluates pre-aggregation expressions the same
    way, core/groupby/groupby.py agg path).
    """
    if not keys:
        # global aggregation: 1-row table of full-column reductions
        return Table({ne.name: evaluate(ne.expr, tbl) for ne in agg_exprs})
    work = tbl
    specs: List[AggSpec] = []
    tmp_i = 0
    for ne in agg_exprs:
        e = ne.expr
        if isinstance(e, Agg):
            child = e.children[0]
            if isinstance(child, Col):
                in_name = child.name
            else:
                in_name = f"__tmp{tmp_i}"
                tmp_i += 1
                work = work.with_column(in_name, evaluate(child, work))
            specs.append(AggSpec(in_name, e.kind, ne.name, e.param or 0.0))
        elif isinstance(e, Len):
            specs.append(AggSpec("", "size", ne.name))
        else:
            raise ValueError(f"groupby agg must be an aggregation: {e!r}")
    out = groupby_aggregate(work, keys, specs)
    return out.select(keys + [ne.name for ne in agg_exprs])


def _sync(tbl: Table) -> None:
    """Wait for the device work behind every buffer of ``tbl``. A deferred
    column of a file scan is not decoded for it: it has no device work yet,
    and its decode belongs to the node that first uses it."""
    pending = set(tbl.undecoded())
    for n in tbl.names:
        if n in pending:
            continue
        c = tbl[n]
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)
            return


def execute_with_profile(node: IR):
    """(result, profile): per-node wall times, the cudf-polars Timer analog
    (reference utils/timer.py + the engine `profiling` docs). Each entry is
    (node_type, seconds, output_rows), in execution order; device work is
    awaited per node (``torch.cuda.synchronize``), so times are real, not
    dispatch-only — use for plan debugging, not micro-benchmarks.

    Unlike the reference's, whose times include the node's inputs, each
    time is the node's own (its inputs' times taken out), so a join's entry
    is its build, probe and gathers only; and the plan runs as ``execute``
    runs it, projection pushdown included. The result is the same."""
    profile = []
    run = _pruned_exec(node)
    inner = [0.0]  # time spent in the inputs of the node being timed

    def _timed(n: IR, visitor) -> Table:
        inner.append(0.0)
        t0 = time.perf_counter()
        out = run(n, visitor)
        _sync(out)
        total = time.perf_counter() - t0
        own = total - inner.pop()
        inner[-1] += total
        profile.append((type(n).__name__, own, out.num_rows))
        return out

    result = CachingVisitor(_timed)(node)
    return result, profile


def _expr_cols(e, out: set):
    """Column names referenced by an expression tree."""
    if type(e).__name__ == "Col":
        out.add(e.args[0])
    for c in getattr(e, "children", ()) or ():
        _expr_cols(c, out)


def scan_column_requirements(root: IR):
    """Projection pushdown requirements: {DataFrameScan or Scan node: set |
    None}.

    The cudf-polars optimizer prunes scan columns before evaluation
    (python/cudf_polars: polars does it in Rust; the streaming lowering
    re-derives per-node schemas). Here a top-down pass computes which
    columns each scan must actually provide; None = all (an unknown node
    type above it). At TPC-H SF10 it keeps the lineitem columns a query
    never reads off the device's work: no node copies or compacts them."""
    needs: dict = {}
    filter_out: dict = {}  # Filter node -> columns its PARENT needs

    def mark(n, needed):
        if isinstance(n, Filter):
            if n in filter_out:
                prev = filter_out[n]
                filter_out[n] = None if (prev is None or needed is None) \
                    else prev | needed
            else:
                filter_out[n] = None if needed is None else set(needed)
        if isinstance(n, (DataFrameScan, Scan)):
            if n in needs:
                prev = needs[n]
                needs[n] = None if (prev is None or needed is None) \
                    else prev | needed
            else:
                needs[n] = None if needed is None else set(needed)
            return
        ch = n.children
        if isinstance(n, Filter):
            sub = set() if needed is not None else None
            if sub is not None:
                sub |= needed
                _expr_cols(n.predicate, sub)
            mark(ch[0], sub)
        elif isinstance(n, (Select, Reduce)):
            sub: set = set()
            for name, e in n.args[0]:
                if needed is None or name in needed:
                    _expr_cols(e, sub)
            mark(ch[0], sub)
        elif isinstance(n, HStack):
            if needed is None:
                mark(ch[0], None)
            else:
                sub = set(needed)
                for name, e in n.args[0]:
                    if name in needed:
                        _expr_cols(e, sub)
                        sub.discard(name)
                # conservatively keep child columns the parent asks for
                mark(ch[0], sub | set(needed))
        elif isinstance(n, GroupBy):
            sub = set(n.args[0])
            for name, e in n.args[1]:
                _expr_cols(e, sub)
            mark(ch[0], sub)
        elif isinstance(n, Join):
            lo, ro = n.args[0], n.args[1]
            if needed is None:
                mark(ch[0], None)
                mark(ch[1], None)
            else:
                # over-approximate: suffix-stripped parent needs + keys to
                # BOTH sides (extra names are intersected away at the scan)
                suf = n.args[4]
                stripped = set()
                for name in needed:
                    stripped.add(name)
                    for s in suf:
                        if s and name.endswith(s):
                            stripped.add(name[: -len(s)])
                mark(ch[0], stripped | set(lo))
                mark(ch[1], stripped | set(ro))
        elif isinstance(n, Sort):
            mark(ch[0], None if needed is None else needed | set(n.args[0]))
        elif isinstance(n, Distinct):
            subset = n.args[0]
            if needed is None or subset is None:
                mark(ch[0], None)
            else:
                mark(ch[0], needed | set(subset))
        elif isinstance(n, (Slice, Cache, Sink)):
            mark(ch[0], needed)
        elif isinstance(n, Projection):
            mark(ch[0], set(n.args[0]))
        elif isinstance(n, (Union, HConcat)):
            for c in ch:
                mark(c, needed)
        else:  # unknown node: require everything below it
            for c in ch:
                mark(c, None)

    mark(root, None)
    return needs, filter_out


def execute(node: IR) -> Table:
    """In-memory recursive evaluation (reference ir.py IR.evaluate)."""
    return CachingVisitor(_pruned_exec(node))(node)


def _pruned_exec(node: IR):
    """The executor's node function with the projection pushdown of
    ``scan_column_requirements`` applied to scans and filters."""
    needs, filter_out = scan_column_requirements(node)
    pruned = {n: cols for n, cols in needs.items() if cols is not None}
    f_pruned = {n: cols for n, cols in filter_out.items() if cols is not None}

    def _exec_pruned(n: IR, visitor) -> Table:
        if isinstance(n, (DataFrameScan, Scan)) and n in pruned:
            tbl = _exec_node(n, visitor)
            keep = [c for c in tbl.names if c in pruned[n]]
            if len(keep) < len(tbl.names):
                return tbl.select(keep)
            return tbl
        if isinstance(n, Filter) and n in f_pruned:
            return _filter(visitor(n.children[0]), n.predicate, f_pruned[n])
        return _exec_node(n, visitor)

    return _exec_pruned


def _filter(child: Table, predicate: Expr, needed=None) -> Table:
    """The rows of ``child`` where ``predicate`` holds. With ``needed`` (the
    pushdown's columns for the parent) only those columns are compacted:
    the predicate-only ones would otherwise be compacted and then dropped."""
    mask = evaluate(predicate, child)
    if needed is not None:
        keep = [c for c in child.names if c in needed]
        if keep and len(keep) < len(child.names):
            child = child.select(keep)
    return stream_compaction.apply_boolean_mask(child, mask)


def _not_ported(what: str, item: int, module: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item "
                               f"{item}, {module})")


def _exec_node(n: IR, visitor) -> Table:
    if isinstance(n, DataFrameScan):
        return n._tbl
    if isinstance(n, Scan):
        from ..io import scan as io_scan

        fmt, paths, columns, device = n.args
        return io_scan(fmt, list(paths), None if columns is None else list(columns),
                       device=device)
    if isinstance(n, Select):
        child = visitor(n.children[0])
        return Table({ne.name: evaluate(ne.expr, child) for ne in n.exprs})
    if isinstance(n, HStack):
        out = visitor(n.children[0])
        for ne in n.exprs:
            out = out.with_column(ne.name, evaluate(ne.expr, out))
        return out
    if isinstance(n, Filter):
        return _filter(visitor(n.children[0]), n.predicate)
    if isinstance(n, GroupBy):
        child = visitor(n.children[0])
        return _groupby_via_specs(child, n.keys, n.agg_exprs)
    if isinstance(n, Join):
        left = visitor(n.children[0])
        right = visitor(n.children[1])
        lo, ro, how, ne_, suf = n.args
        # engine contract matches cudf-polars/libcudf: join row order is
        # unspecified (maintain_order defaults off), which lets an inner
        # join build on its smaller side
        return join_ops.join(left, right, list(lo), list(ro), how, ne_, suf,
                             ordered=False)
    if isinstance(n, Sort):
        child = visitor(n.children[0])
        by, desc, nl = n.args
        return sorting.sort_by_key(child, list(by), list(desc), list(nl))
    if isinstance(n, Distinct):
        child = visitor(n.children[0])
        subset, keep = n.args
        return stream_compaction.distinct(child, None if subset is None else list(subset),
                                          keep)
    if isinstance(n, Slice):
        return visitor(n.children[0]).slice(n.args[0], n.args[1])
    if isinstance(n, Union):
        return copying.concatenate_tables([visitor(c) for c in n.children])
    if isinstance(n, HConcat):
        cols = {}
        for t in [visitor(c) for c in n.children]:
            for name, c in t:
                cols[name] = c
        return Table(cols)
    if isinstance(n, Projection):
        return visitor(n.children[0]).select(list(n.args[0]))
    if isinstance(n, Empty):
        return Table({})
    if isinstance(n, Sink):
        from ..io import write as io_write

        child = visitor(n.children[0])
        io_write(child, n.args[0], n.args[1])
        return child
    if isinstance(n, (Cache, Shuffle, Repartition)):
        # single-partition in-memory execution: shuffling is a no-op
        return visitor(n.children[0])
    if isinstance(n, Reduce):
        child = visitor(n.children[0])
        return Table({ne.name: evaluate(ne.expr, child) for ne in n.exprs})
    if isinstance(n, Rolling):
        from ..ops import rolling as rolling_ops

        orderby, window, aggs, range_based = n.args
        out = sorting.sort_by_key(visitor(n.children[0]), [orderby])
        cols = dict(out)
        for out_name, vname, kind in aggs:
            if range_based:
                cols[out_name] = rolling_ops.rolling_range(out[vname], out[orderby],
                                                           window, kind)
            else:
                cols[out_name] = rolling_ops.rolling(out[vname], window, kind)
        return Table(cols)
    if isinstance(n, ConditionalJoin):
        raise _not_ported("ConditionalJoin", 8, "ops/join.py:conditional_join")
    if isinstance(n, MergeSorted):
        from ..ops.merge import merge_sorted

        return merge_sorted([visitor(c) for c in n.children], [n.args[0]])
    if isinstance(n, MapFunction):
        child = visitor(n.children[0])
        name, options = n.args
        if name == "rename":
            return child.rename(dict(options))
        if name == "row_index":
            from ..ops.filling import sequence

            (out_name,) = options or ("index",)
            return Table({out_name: sequence(child.num_rows, device=child.device),
                          **dict(child)})
        if name == "explode":
            raise _not_ported("MapFunction explode", 14, "core/lists.py")
        raise ValueError(f"unknown MapFunction {name!r}")
    raise TypeError(f"cannot execute {type(n).__name__}")
