"""Parquet extensions: row-group pruning, the chunked reader and writer
(counterpart of ``cudf_tpu/io/parquet_ext.py``).

Reference analogs:
  * predicate pushdown on row-group statistics —
    cpp/src/io/parquet/predicate_pushdown.cpp (row groups whose stats rule
    the predicates out are skipped before any data page is read);
  * the chunked reader — cpp/src/io/parquet/reader_impl_chunking.hpp:24-100
    pass/subpass planning;
  * the chunked writer — cpp/src/io/parquet/writer_impl.cu's chunked API;
  * datasource-driven reads — readers pull byte ranges through
    ``io/datasource.py``, so a remote source fetches only surviving row
    groups.

Decode stays on the host in pyarrow, as in the rest of ``io/``; this module
owns the planning (which row groups to touch, and in what chunks) and the
writer. Every reader takes ``device=None``, which means CUDA and raises
without it. The chunked reader decodes on a worker thread and copies each
chunk to the device on the consumer's thread, on its current stream, so a
copy never races the kernels that read it; an exception on the worker
reaches the consumer.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.column import Column, resolve_device
from ..core.table import Table
from .datasource import Datasource

# predicate: (column, op, literal) with op in {==, !=, <, <=, >, >=, in}
Pred = Tuple[str, str, object]


def _rg_survives(meta_rg, schema_names, conjunction: Sequence[Pred]) -> bool:
    """Can this row group hold rows satisfying every predicate?"""
    for colname, op, lit in conjunction:
        if colname not in schema_names:
            continue
        st = meta_rg.column(schema_names.index(colname)).statistics
        if st is None or not st.has_min_max:
            continue  # no stats: cannot prune
        lo, hi = st.min, st.max
        try:
            if op == "==" and (lit < lo or lit > hi):
                return False
            if op == "<" and not lo < lit:
                return False
            if op == "<=" and not lo <= lit:
                return False
            if op == ">" and not hi > lit:
                return False
            if op == ">=" and not hi >= lit:
                return False
            if op == "in" and all(x < lo or x > hi for x in lit):
                return False
        except TypeError:
            continue  # incomparable types: keep the group
    return True


def prune_row_groups(path_or_ds: Union[str, Datasource],
                     predicates: Optional[Sequence[Pred]]) -> Tuple[List[int], int]:
    """(surviving row-group indices, total row groups), by stats only."""
    import pyarrow.parquet as pq

    ds = Datasource.open(path_or_ds)
    md = pq.ParquetFile(ds.as_file()).metadata
    names = [md.schema.column(i).name for i in range(md.num_columns)]
    total = md.num_row_groups
    if not predicates:
        return list(range(total)), total
    return [i for i in range(total)
            if _rg_survives(md.row_group(i), names, predicates)], total


def read_parquet_pruned(path_or_ds: Union[str, Datasource],
                        columns: Optional[Sequence[str]] = None,
                        predicates: Optional[Sequence[Pred]] = None,
                        exact: bool = True, device=None) -> Table:
    """Read the row groups that stats pruning keeps (this module's own
    pruning, not pyarrow's ``filters``). ``exact`` then applies the
    predicates row by row: pruning alone keeps a superset."""
    import pyarrow.parquet as pq

    dev = resolve_device(device)
    ds = Datasource.open(path_or_ds)
    pf = pq.ParquetFile(ds.as_file())
    keep, _ = prune_row_groups(ds, predicates)
    cols = list(columns) if columns else None
    if not keep:
        empty = pf.schema_arrow.empty_table()
        return Table.from_arrow(empty if cols is None else empty.select(cols), dev)
    t = Table.from_arrow(pf.read_row_groups(keep, columns=cols), dev)
    if exact and predicates:
        t = _apply_predicates(t, predicates)
    return t


def _apply_predicates(t: Table, predicates: Sequence[Pred]) -> Table:
    from ..ops import binaryop
    from ..ops.search import contains
    from ..ops.stream_compaction import apply_boolean_mask

    opmap = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
    mask = None
    for colname, op, lit in predicates:
        if colname not in t.names:
            continue
        c = t[colname]
        if op == "in":
            m = contains(Column.from_numpy(np.asarray(list(lit)), device=c.device), c)
        else:
            if isinstance(lit, np.datetime64) or type(lit).__name__ == "Timestamp":
                lit = np.datetime64(lit)
            m = binaryop.binary_op(c, lit, opmap[op])
        mask = m if mask is None else binaryop.binary_op(mask, m, "and")
    return t if mask is None else apply_boolean_mask(t, mask)


class ChunkedParquetReader:
    """Budget-driven chunked parquet reader: the pass/subpass planner of
    cpp/src/io/parquet/reader_impl_chunking.hpp:24-100 for a host decode.

    Planning reads only row-group metadata, at two levels:

    * a **pass** is a maximal run of surviving row groups whose summed
      compressed size (selected columns only) fits ``pass_read_limit``: the
      bytes held from the source at once. A remote source prefetches a
      pass's byte ranges in parallel (``prefetch_ranges``);
    * a **subpass** is a run of a pass's row groups whose summed
      uncompressed size fits ``chunk_read_limit``: one yielded Table. A
      single row group larger than the limit is a subpass of its own.

    With ``prefetch``, a worker thread decodes subpass k + 1 while the
    consumer works on chunk k.
    """

    def __init__(self, path_or_ds: Union[str, Datasource],
                 columns: Optional[Sequence[str]] = None,
                 predicates: Optional[Sequence[Pred]] = None,
                 chunk_read_limit: int = 256 << 20,
                 pass_read_limit: int = 1 << 30,
                 prefetch: bool = True,
                 exact: bool = True, device=None):
        import pyarrow.parquet as pq

        self.device = resolve_device(device)
        self.ds = Datasource.open(path_or_ds)
        self._pf = pq.ParquetFile(self.ds.as_file())
        self.columns = list(columns) if columns else None
        self.predicates = list(predicates) if predicates else None
        self.exact = exact
        self.prefetch = prefetch
        md = self._pf.metadata
        names = [md.schema.column(i).name for i in range(md.num_columns)]
        col_idx = (list(range(md.num_columns)) if self.columns is None else
                   [names.index(c) for c in self.columns if c in names])
        keep, _ = prune_row_groups(self.ds, self.predicates)

        def rg_sizes(i):
            rg = md.row_group(i)
            return (sum(rg.column(j).total_compressed_size for j in col_idx),
                    sum(rg.column(j).total_uncompressed_size for j in col_idx))

        self.passes: List[List[int]] = []
        cur, cur_comp = [], 0
        for i in keep:
            comp, _ = rg_sizes(i)
            if cur and cur_comp + comp > pass_read_limit:
                self.passes.append(cur)
                cur, cur_comp = [], 0
            cur.append(i)
            cur_comp += comp
        if cur:
            self.passes.append(cur)
        self.plan: List[List[int]] = []  # one entry a yielded chunk
        self.plan_bytes: List[int] = []
        self._chunk_pass: List[int] = []  # chunk -> its pass
        for pi, p in enumerate(self.passes):
            sub, sub_unc = [], 0
            for i in p:
                _, unc = rg_sizes(i)
                if sub and sub_unc + unc > chunk_read_limit:
                    self.plan.append(sub)
                    self.plan_bytes.append(sub_unc)
                    self._chunk_pass.append(pi)
                    sub, sub_unc = [], 0
                sub.append(i)
                sub_unc += unc
            if sub:
                self.plan.append(sub)
                self.plan_bytes.append(sub_unc)
                self._chunk_pass.append(pi)
        self._prefetch_pass_bytes(0)

    def _prefetch_pass_bytes(self, pass_idx: int) -> None:
        """Parallel range prefetch of one pass's pages (remote sources)."""
        if not hasattr(self.ds, "prefetch_ranges") or pass_idx >= len(self.passes):
            return
        md = self._pf.metadata
        ranges = []
        for i in self.passes[pass_idx]:
            rg = md.row_group(i)
            for j in range(rg.num_columns):
                c = rg.column(j)
                off = c.dictionary_page_offset or c.data_page_offset
                end = c.data_page_offset + c.total_compressed_size
                ranges.append((int(off), int(end - off)))
        self.ds.prefetch_ranges(ranges)

    def _decode(self, rgs: List[int]):
        """Host decode of row groups ``rgs`` (a pyarrow Table); runs on the
        prefetch worker."""
        return self._pf.read_row_groups(rgs, columns=self.columns)

    def _to_table(self, at) -> Table:
        """A decoded chunk on the device, predicates applied (consumer's
        thread)."""
        t = Table.from_arrow(at, self.device)
        if self.exact and self.predicates:
            t = _apply_predicates(t, self.predicates)
        return t

    def __iter__(self):
        if not self.plan:
            empty = self._pf.schema_arrow.empty_table()
            yield Table.from_arrow(empty.select(self.columns) if self.columns else empty,
                                   self.device)
            return
        if not self.prefetch:
            for rgs in self.plan:
                yield self._to_table(self._decode(rgs))
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._decode, self.plan[0])
            for k in range(len(self.plan)):
                at = fut.result()
                if k + 1 < len(self.plan):
                    if self._chunk_pass[k + 1] != self._chunk_pass[k]:
                        self._prefetch_pass_bytes(self._chunk_pass[k + 1])
                    fut = ex.submit(self._decode, self.plan[k + 1])
                yield self._to_table(at)
                del at


class ParquetChunkedWriter:
    """Incremental parquet writer (cudf's chunked_parquet_writer analog).

    Each ``write(table)`` appends row groups of at most ``row_group_rows``
    rows; stats and dictionary encoding come from the arrow writer. As a
    context manager the sink is atomic: a write that raises removes the
    partial file (SURVEY §5: sink atomicity is the durability contract).
    """

    def __init__(self, path: str, row_group_rows: int = 1 << 20, **writer_kwargs):
        self.path = path
        self.row_group_rows = row_group_rows
        self._writer = None
        self._kwargs = writer_kwargs

    def write(self, tbl: Table) -> None:
        import pyarrow.parquet as pq

        at = tbl.to_arrow()
        if self._writer is None:
            self._writer = pq.ParquetWriter(self.path, at.schema, **self._kwargs)
        self._writer.write_table(at, row_group_size=self.row_group_rows)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        elif self._writer is not None:
            self._writer.close()
            self._writer = None
            if os.path.exists(self.path):
                os.remove(self.path)
        return False
