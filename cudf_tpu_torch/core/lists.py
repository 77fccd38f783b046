"""List columns: Arrow offsets plus a child column (counterpart of
``cudf_tpu/core/lists.py``).

Analog of cpp/src/lists/: construction from and to host lists, explode,
lengths, element extraction and groupby COLLECT_LIST. A ``ListColumn``
holds int32 ``offsets`` of exactly ``length + 1`` entries (the reference
pads them to a capacity bucket; the port keeps the bucket only on the
child and on the row validity, which is ``bool[bucket_capacity(length)]``
like a Column's), a child ``Column`` of ``offsets[-1]`` rows and an
optional row validity.

Lists built from a dictionary-encoded column (``from_codes``: string
splits, tokenizers, list-valued pandas cells) keep their per-value items
on the host, once per distinct value; the rows' offsets and the child are
built on the device by gathering each row's item count by its code, a
cumulative sum and one gather of the items, so the codes never leave the
device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import dtypes
from .column import Column, _pad_to, resolve_device
from .dtypes import Kind
from ..utils.padding import bucket_capacity


class ListColumn:
    """offsets int32[length + 1] + child Column + row validity."""

    __slots__ = ("offsets", "child", "length", "validity")

    def __init__(self, offsets: torch.Tensor, child: Column, length: int,
                 validity: Optional[torch.Tensor] = None):
        self.offsets = offsets
        self.child = child
        self.length = int(length)
        self.validity = validity
        assert offsets.shape[0] == self.length + 1, (offsets.shape, self.length)

    @property
    def device(self) -> torch.device:
        return self.child.device

    @property
    def dtype(self) -> dtypes.DType:
        return dtypes.DType(Kind.LIST, 32, self.child.dtype)

    @property
    def capacity(self) -> int:
        return bucket_capacity(self.length)

    def __len__(self) -> int:
        return self.length

    def __repr__(self) -> str:  # pragma: no cover
        return f"ListColumn(len={self.length}, child={self.child!r})"

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_pylist(cls, rows: Sequence[Optional[Sequence]], device=None) -> "ListColumn":
        """From host rows; ``None`` is a null list."""
        dev = resolve_device(device)
        offs = [0]
        flat: List = []
        valid = []
        for r in rows:
            valid.append(r is not None)
            if r is not None:
                flat.extend(r)
            offs.append(len(flat))
        n = len(rows)
        offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
        child = Column.from_numpy(np.asarray(flat), device=dev)
        v = None if all(valid) else _pad_to(np.asarray(valid), bucket_capacity(n), dev,
                                            False)
        return cls(offsets, child, n, v)

    def to_pylist(self) -> List:
        offs = self.offsets.cpu().numpy()
        vals = self.child.to_numpy()
        v = None if self.validity is None else self.validity[: self.length].cpu().numpy()
        return [None if v is not None and not v[i] else list(vals[offs[i]: offs[i + 1]])
                for i in range(self.length)]

    def to_numpy(self) -> np.ndarray:
        """An object array of the rows' lists (None for a null)."""
        out = np.empty(self.length, object)
        out[:] = self.to_pylist()
        return out

    def to_pandas(self, name=None):
        from ..utils.real_pandas import pd

        return pd.Series(self.to_numpy(), name=name, dtype=object)

    # ---------------------------------------------------------------- access
    def _row_lengths(self) -> torch.Tensor:
        return (self.offsets[1:] - self.offsets[:-1]).to(torch.int64)

    def lengths(self) -> Column:
        out = torch.zeros(self.capacity, dtype=torch.int32, device=self.device)
        out[: self.length] = self._row_lengths().to(torch.int32)
        return Column(dtypes.int32, out, self.validity, self.length)

    def parent_ids(self) -> torch.Tensor:
        """int64[child.capacity]: the owning row of each child element
        (padding rows point at row 0)."""
        ids = torch.repeat_interleave(
            torch.arange(self.length, device=self.device), self._row_lengths(),
            output_size=self.child.length)
        out = torch.zeros(self.child.capacity, dtype=torch.int64, device=self.device)
        out[: self.child.length] = ids
        return out

    def explode(self):
        """(parent_row_index Column, child Column): cudf::lists::explode."""
        parent = Column(dtypes.int32, self.parent_ids().to(torch.int32), None,
                        self.child.length)
        return parent, self.child

    def extract(self, index: int) -> Column:
        """list[i] per row; null when out of bounds (extract_list_element)."""
        cap = self.capacity
        n = self.length
        starts = torch.zeros(cap, dtype=torch.int64, device=self.device)
        ln = torch.zeros(cap, dtype=torch.int64, device=self.device)
        starts[:n] = self.offsets[:-1].to(torch.int64)
        ln[:n] = self._row_lengths()
        idx = ln + index if index < 0 else torch.full_like(ln, index)
        ok = (idx >= 0) & (idx < ln)
        src = (starts + idx).clamp(0, self.child.capacity - 1)
        data = self.child.data[src]
        v = ok
        if self.validity is not None:
            v = v & self.validity
        if self.child.validity is not None:
            v = v & self.child.validity[src]
        return Column(self.child.dtype, data, v, n, self.child.dictionary)


def from_codes(col: Column, counts: np.ndarray, items: Column,
               item_offsets: Optional[np.ndarray] = None) -> ListColumn:
    """A ListColumn whose row ``i`` holds the items of its code:
    ``items[item_offsets[c]: item_offsets[c] + counts[c]]`` for
    ``c = col.data[i]``. ``counts`` and ``item_offsets`` are per dictionary
    value (host, small); the rows' offsets come from a device gather of the
    counts by code and a cumulative sum, and the child from one gather of
    ``items``. A null row is a null list."""
    dev = col.device
    n = col.length
    counts = np.asarray(counts, np.int64)
    if item_offsets is None:
        item_offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    k = max(len(counts), 1)
    cnt_t = torch.zeros(k, dtype=torch.int64, device=dev)
    off_t = torch.zeros(k, dtype=torch.int64, device=dev)
    if len(counts):
        cnt_t[: len(counts)] = torch.from_numpy(counts).to(dev)
        off_t[: len(counts)] = torch.from_numpy(np.asarray(item_offsets, np.int64)).to(dev)
    codes = col.data[:n].to(torch.int64)
    ok = col.valid_mask()[:n] & (codes >= 0) & (codes < len(counts))
    codes = torch.where(ok, codes, 0)
    lens = torch.where(ok, cnt_t[codes], 0)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1].item()) if n else 0  # the one host read: the child size
    parent = torch.repeat_interleave(torch.arange(n, device=dev), lens, output_size=total)
    src = torch.zeros(bucket_capacity(total), dtype=torch.int64, device=dev)
    src[:total] = off_t[codes[parent]] + (torch.arange(total, device=dev)
                                          - offsets[parent])
    from ..ops.copying import gather

    child = gather(items, src, total)
    v = None
    if col.validity is not None:
        v = torch.zeros(bucket_capacity(n), dtype=torch.bool, device=dev)
        v[:n] = col.validity[:n]
    return ListColumn(offsets.to(torch.int32), child, n, v)


def items_column(values: Sequence, device) -> Column:
    """A column of host items (the flattened values of list cells), typed as
    pandas infers them: bools bool, ints int64 (float64 with NaN when some
    are missing), other numbers float64, anything else strings; ``None``
    and NaN are nulls."""
    from ..utils.real_pandas import pd

    arr = np.empty(len(values), object)
    arr[:] = list(values)
    isnull = pd.isna(arr)
    kind = pd.api.types.infer_dtype(arr, skipna=True)
    if kind == "boolean" and not isnull.any():
        return Column.from_numpy(arr.astype(bool), device=device)
    if kind == "integer" and not isnull.any():
        return Column.from_numpy(arr.astype(np.int64), device=device)
    if kind in ("integer", "floating", "mixed-integer-float", "empty"):
        return Column.from_numpy(np.where(isnull, np.nan, arr).astype(np.float64),
                                 device=device)
    if kind != "string":
        arr = np.where(isnull, None, arr.astype(str).astype(object))
    return Column.from_numpy(arr, ~isnull if isnull.any() else None, device=device)


def _cell_items(x) -> list:
    """A cell's items for explode: a list-like's elements, none for a
    missing cell, the cell itself for any other scalar (pandas)."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return list(x)
    try:
        missing = x is None or bool(x != x)
    except (TypeError, ValueError):  # pd.NA and other ambiguous missing values
        missing = True
    return [] if missing else [x]


def from_object_column(col: Column) -> ListColumn:
    """The ListColumn of a column whose dictionary holds list cells (the
    ingest of list-valued pandas cells, ``Series.str.split(expand=False)``):
    each distinct cell is flattened once on the host; a scalar cell is a
    list of itself."""
    cells = col.dictionary if col.dictionary is not None else np.array([], object)
    items = [_cell_items(c) for c in cells]
    counts = np.fromiter(map(len, items), np.int64, len(items))
    return from_codes(col, counts, items_column(
        [x for it in items for x in it], col.device))


def explode_rows(lc: ListColumn):
    """pandas explode of a ListColumn: (parent gather map int64[capacity],
    rows, values Column), where an empty or null list keeps one null row."""
    dev = lc.device
    n = lc.length
    lens = lc._row_lengths()
    if lc.validity is not None:
        lens = torch.where(lc.validity[:n], lens, 0)
    eff = lens.clamp(min=1)
    offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(eff, 0, out=offs[1:])
    total = int(offs[-1].item()) if n else 0
    cap = bucket_capacity(total)
    parent = torch.zeros(cap, dtype=torch.int64, device=dev)
    parent[:total] = torch.repeat_interleave(torch.arange(n, device=dev), eff,
                                             output_size=total)
    within = torch.arange(cap, device=dev) - offs[parent]
    has = (within < lens[parent]) & (torch.arange(cap, device=dev) < total)
    src = lc.offsets.to(torch.int64)[parent] + within
    from ..ops.copying import gather

    vals = gather(lc.child, torch.where(has, src, 0), total)
    v = has if vals.validity is None else has & vals.validity
    return parent, total, Column(vals.dtype, vals.data, v, total, vals.dictionary)


def is_list_cells(col) -> bool:
    """True for a dictionary column of host cells (not a categorical)."""
    return isinstance(col, Column) and col.dtype.kind == Kind.DICTIONARY \
        and col.dtype.param is None and col.dictionary is not None


def groupby_collect(tbl, keys: Sequence[str], value: str):
    """groupby().agg(list): COLLECT_LIST (reference group_collect.cu).

    Returns (key Table, ListColumn) with groups in sorted key order and each
    list's values in row order."""
    from ..ops.copying import gather
    from ..ops.groupby import AggSpec, _aggregate_impl, _grouping_codes, _grouping_finish
    from ..ops.sortprim import multisort_perm
    from .table import Table

    kcols = [tbl[k] for k in keys]
    perm = multisort_perm(_grouping_codes(kcols))
    seg, _, live, n_groups = _grouping_finish(kcols, perm)
    out = _aggregate_impl(kcols, [kcols[0]], list(keys), [AggSpec("", "size", "__n")],
                          bucket_capacity(n_groups), perm, seg, live, n_groups, [None])
    offsets = torch.zeros(n_groups + 1, dtype=torch.int32, device=perm.device)
    offsets[1:] = torch.cumsum(out["__n"].data[:n_groups], 0).to(torch.int32)
    child = gather(tbl[value], perm, tbl.num_rows)
    return Table({k: out[k] for k in keys}), ListColumn(offsets, child, n_groups)
