"""Out-of-core partitioned execution with host spill (counterpart of
``cudf_tpu/parallel/partitioned.py``).

The analog of cudf-polars' streaming executor's partition-wise task model
(reference: streaming/parallel.py:68-117) and of cuDF's spill manager
(python/cudf/cudf/core/buffer/spill_manager.py). A ``PartitionedFrame`` is
a list of row partitions; a partition is a device Table or a spilled host
copy of one (numpy arrays, or buffers in a native ``PartitionStore`` once
``set_partition_store`` installs one). Operators take one partition to the
device at a time, so a table larger than the device streams through it.
Under an ``utils.hbm`` budget a partition brought back to the device
admits its bytes, which may evict the least recently used resident
partitions (their device tensors are dropped; the host copy stays).

Faults of the reference not copied (each pinned by a test): its
``sort_values`` buckets rows by value comparisons against sampled
splitters, so a NaN or null first key falls into no bucket (the rows are
lost), and it lays buckets out in ascending order whatever ``descending``
says. Here rows are bucketed by the port's order operands
(``sorting._order_operands``: each key's flags, NaN and null placement
included) against splitter tuples, three ways (below, equal, above each
splitter), so every row lands in exactly one bucket and buckets come out in
output order; the result equals ``sort_by_key`` of the concatenated
partitions exactly.

Entry points take ``device=None``, which means CUDA and raises without it:
the device a spilled partition comes back to.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.column import Column, _pad_to, resolve_device
from ..core.dtypes import DType
from ..core.table import Table
from ..utils.padding import bucket_capacity

_STORE = None

# host copies made by spills and un-spills of CUDA partitions (chip_smoke.py
# prints them; reset by assigning zeros)
transfers = {"to_host_bytes": 0, "to_host_s": 0.0, "to_device_bytes": 0, "to_device_s": 0.0}


def set_partition_store(store) -> None:
    """Install a native ``utils.native.PartitionStore`` as the home of
    partitions spilled from now on; None reverts to plain numpy arrays."""
    global _STORE
    _STORE = store


class _HostColumn(NamedTuple):
    data: object                 # ndarray, or a store id when ``store`` is set
    validity: object             # ndarray, store id or None
    dtype: DType
    dictionary: Optional[np.ndarray]
    length: int


class _Partition:
    """A device Table, or a spilled host copy of one that ``get`` brings
    back to ``device``."""

    def __init__(self, table: Optional[Table] = None,
                 host: Optional[Dict[str, _HostColumn]] = None, store=None,
                 device=None):
        self.table = table
        self.host = host
        self.store = store
        self.device = resolve_device(device) if table is None else table.device
        self._budget_finalizer = None

    @property
    def num_rows(self) -> int:
        if self.table is not None:
            return self.table.num_rows
        return next(iter(self.host.values())).length if self.host else 0

    def get(self) -> Table:
        """The partition on the device; under a budget it stays resident
        (LRU) once admitted."""
        from ..utils.hbm import get_hbm_budget, table_device_bytes

        budget = get_hbm_budget()
        if self.table is not None:
            if budget is not None:
                budget.touch(id(self))
            return self.table
        tbl = self._unspill()
        if budget is not None:
            # the eviction callback holds a weakref, so a dropped frame can
            # be collected while still registered; collection releases it
            self.table = tbl
            ref = weakref.ref(self)
            budget.admit(id(self), table_device_bytes(tbl),
                         lambda: (lambda p: p.spill() if p is not None else None)(ref()))
            if self._budget_finalizer is None:
                self._budget_finalizer = weakref.finalize(self, budget.release, id(self))
        return tbl

    def take(self) -> Table:
        """The partition on the device, released from the budget: for a
        partition read once and then dropped."""
        from ..utils.hbm import get_hbm_budget

        tbl = self.get()
        budget = get_hbm_budget()
        if budget is not None:
            budget.release(id(self))
        if self.host is not None:
            self.table = None
        return tbl

    def spill(self) -> None:
        """Drop the device references (the budget's eviction callback),
        copying to the host first if there is no host copy yet."""
        if self.table is None:
            return
        if self.host is None:
            self.host, self.store = _host_copy(self.table)
            _own_buffers(self)
        self.table = None

    def _unspill(self) -> Table:
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        nbytes = 0
        cols = {}
        for name, h in self.host.items():
            data, validity = h.data, h.validity
            if self.store is not None:
                data = self.store.get(data)
                validity = None if validity is None else self.store.get(validity)
            cap = bucket_capacity(h.length)
            d = _pad_to(data, cap, self.device)
            v = None if validity is None else _pad_to(validity, cap, self.device, False)
            nbytes += data.nbytes + (0 if validity is None else validity.nbytes)
            cols[name] = Column(h.dtype, d, v, h.length, h.dictionary)
        if cuda:
            torch.cuda.synchronize(self.device)
            transfers["to_device_bytes"] += nbytes
            transfers["to_device_s"] += time.perf_counter() - t0
        return Table(cols)

    @staticmethod
    def spilled(tbl: Table, device=None) -> "_Partition":
        """A host copy of ``tbl``'s logical rows (into the installed store,
        if any) that comes back to ``device`` (default: ``tbl``'s own)."""
        dev = tbl.device if device is None and tbl.num_columns else resolve_device(device)
        host, store = _host_copy(tbl)
        part = _Partition(host=host, store=store, device=dev)
        _own_buffers(part)
        return part


def _host_copy(tbl: Table):
    """(host columns, store): ``tbl``'s logical rows copied to the host,
    into the installed store if there is one. The copy is synchronous."""
    src_cuda = tbl.num_columns > 0 and tbl.device.type == "cuda"
    t0 = time.perf_counter()
    nbytes = 0
    host = {}
    for name, c in tbl:
        n = c.length
        data = c.data[:n].cpu().numpy()
        validity = None if c.validity is None else c.validity[:n].cpu().numpy()
        nbytes += data.nbytes + (0 if validity is None else validity.nbytes)
        if _STORE is not None:
            data = _STORE.put(data)
            validity = None if validity is None else _STORE.put(validity)
        host[name] = _HostColumn(data, validity, c.dtype, c.dictionary, n)
    if src_cuda:
        transfers["to_host_bytes"] += nbytes
        transfers["to_host_s"] += time.perf_counter() - t0
    return host, _STORE


def _own_buffers(part: _Partition) -> None:
    """Free the partition's store buffers when it is collected."""
    if part.store is not None:
        weakref.finalize(part, _drop_buffers, part.store, part.host)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` (the current card) matches ``cuda:i``."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _drop_buffers(store, host: Dict[str, _HostColumn]) -> None:
    """Free a collected partition's buffers in the native store."""
    if store is None or store._h is None:
        return
    for h in host.values():
        store.drop(h.data)
        if h.validity is not None:
            store.drop(h.validity)


def _key_alignment(parts: Sequence[_Partition], keys: Sequence[str]) -> Dict[str, tuple]:
    """For each key: (the union dictionary of a string key whose
    partitions' dictionaries differ, else None; whether any partition has
    a validity mask), read without bringing a partition to the device."""
    from ..ops.strings import union_dictionary

    align = {}
    for k in keys:
        cols = [p.table[k] if p.table is not None else p.host[k] for p in parts]
        dicts = [c.dictionary for c in cols]
        merged = None
        if cols[0].dtype.is_string:
            merged = union_dictionary(dicts)
        elif any(d is not None for d in dicts) and union_dictionary(dicts) is not None:
            raise ValueError(f"sort key {k!r} has different categories in different partitions")
        align[k] = (merged, any(c.validity is not None for c in cols))
    return align


def _aligned(tbl: Table, align: Dict[str, tuple]) -> Table:
    """``tbl`` with its key columns recoded and masked as ``align`` says."""
    from ..ops.strings import recode

    cols = dict(tbl)
    for k, (merged, masked) in align.items():
        c = cols[k]
        if merged is not None:
            c = recode(c, merged)
        if masked and c.validity is None:
            valid = torch.arange(c.capacity, device=c.device) < c.length
            c = Column(c.dtype, c.data, valid, c.length, c.dictionary)
        cols[k] = c
    return Table(cols)


class PartitionedFrame:
    """A sequence of row partitions, executed one at a time on the device."""

    def __init__(self, partitions: List[_Partition], spill: bool = True, device=None):
        self._parts = partitions
        self._spill = spill
        self.device = resolve_device(device)

    def _wrap(self, tbl: Table) -> _Partition:
        return _Partition.spilled(tbl, self.device) if self._spill else _Partition(table=tbl)

    # ----------------------------------------------------------- construct
    @classmethod
    def from_tables(cls, tables: Sequence[Table], spill: bool = True, device=None):
        """Partitions from tables (copied to the host with ``spill``, one
        at a time as ``tables`` yields them); ``device`` is where they are
        brought back to."""
        dev = resolve_device(device)
        pf = cls([], spill, dev)
        for t in tables:  # one pass: ``tables`` may be a generator
            if not spill and t.num_columns and not _same_device(t.device, dev):
                raise ValueError(f"a table on {t.device} in a frame on {dev}")
            pf._parts.append(pf._wrap(t))
        return pf

    @classmethod
    def from_pandas(cls, df, npartitions: int, spill: bool = True, device=None):
        """``npartitions`` row slices of a pandas frame; spilled ones are
        built on the host and never touch the device here."""
        dev = resolve_device(device)
        idx = np.array_split(np.arange(len(df)), npartitions)
        tables = [Table.from_pandas(df.iloc[i].reset_index(drop=True),
                                    "cpu" if spill else dev) for i in idx]
        return cls.from_tables(tables, spill, dev)

    @classmethod
    def read_parquet_chunked(cls, path, rows_per_chunk: int = 4_000_000,
                             columns=None, spill: bool = True, device=None):
        """A chunked parquet scan: one partition per batch of at most
        ``rows_per_chunk`` rows (reference: reader_impl_chunking passes).
        Spilled partitions are decoded into host arrays and never touch
        the device here."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        dev = resolve_device(device)
        pf = cls([], spill, dev)
        with pq.ParquetFile(path) as f:
            for batch in f.iter_batches(batch_size=rows_per_chunk, columns=columns):
                t = Table.from_arrow(pa.Table.from_batches([batch]),
                                     "cpu" if spill else dev)
                pf._parts.append(pf._wrap(t))
        return pf

    # ------------------------------------------------------------ basic api
    @property
    def npartitions(self) -> int:
        return len(self._parts)

    def num_rows(self) -> int:
        return sum(p.num_rows for p in self._parts)

    def map_partitions(self, fn: Callable[[Table], Table]) -> "PartitionedFrame":
        out = PartitionedFrame([], self._spill, self.device)
        out._parts = [out._wrap(fn(p.get())) for p in self._parts]
        return out

    def filter(self, predicate_fn) -> "PartitionedFrame":
        from ..ops.stream_compaction import apply_boolean_mask

        return self.map_partitions(lambda t: apply_boolean_mask(t, predicate_fn(t)))

    def select(self, names: Sequence[str]) -> "PartitionedFrame":
        return self.map_partitions(lambda t: t.select(list(names)))

    # ------------------------------------------------------------ operators
    def groupby_agg(self, keys: Sequence[str], aggs, dropna_keys=True) -> Table:
        """A partial aggregate per partition, merged and finalized
        (``ops/streaming_groupby.py``): one input partition resident at a
        time beyond what the budget keeps."""
        from ..ops.streaming_groupby import streaming_groupby

        return streaming_groupby((p.get() for p in self._parts), list(keys), list(aggs),
                                 dropna_keys)

    def join_small(self, right: Table, left_on, right_on, how="inner") -> "PartitionedFrame":
        """Broadcast join: the small right side joins every partition."""
        from ..ops.join import join

        return self.map_partitions(
            lambda t: join(t, right, list(left_on), list(right_on), how))

    def sort_values(self, keys: Sequence[str], descending=False,
                    nulls_last=True) -> "PartitionedFrame":
        """Out-of-core sample sort (``chunked.sample_sort``), a bucket's rows
        held as spilled partitions until its turn; equal to ``sort_by_key``
        of the concatenated partitions. A string key is first recoded onto
        the union of the partitions' dictionaries, and a key with a
        validity mask in any partition gets one in every partition, so that
        a row's order operands mean the same in every partition."""
        from ..ops.chunked import _padded, sample_sort
        from ..ops.copying import concatenate_tables, gather_table
        from ..ops.sorting import _norm_flags

        keys = list(keys)
        align = _key_alignment(self._parts, keys)

        def hold(i, t, idx):
            return self._wrap(gather_table(t, _padded(idx, idx.numel()), idx.numel()))

        def fetch(handles):
            tables = [h.take() for h in handles]
            return concatenate_tables(tables) if len(tables) > 1 else tables[0]

        out = PartitionedFrame([], self._spill, self.device)
        for part in sample_sort(self.npartitions, lambda i: _aligned(self._parts[i].get(), align),
                                keys, _norm_flags(len(keys), descending),
                                _norm_flags(len(keys), nulls_last), self.npartitions,
                                hold, fetch):
            out._parts.append(out._wrap(part))
        if not out._parts:
            out._parts.append(out._wrap(self._parts[0].get().slice(0, 0)))
        return out

    def collect(self) -> Table:
        from ..ops.copying import concatenate_tables

        tables = [p.get() for p in self._parts]
        return concatenate_tables(tables) if len(tables) > 1 else tables[0]

    def to_pandas(self):
        from ..utils.real_pandas import pd

        return pd.concat([p.get().to_pandas() for p in self._parts], ignore_index=True)
