"""Table: an ordered mapping of named columns of equal logical length.

Counterpart of ``cudf_tpu/core/table.py``. A table may hold *deferred*
columns, which a file scan (``io.read_parquet``) leaves on disk: each is
decoded and copied to the device at its first access by name, by
``columns`` or by iteration, and never if the query does not touch it.
``select``, ``drop``, ``rename`` and ``with_column`` carry deferred columns
over as they are; host exports (``to_pandas``, ``to_arrow``) decode a
deferred column on the host and copy nothing to the device. The reference
defers the device buffer inside its ``Column`` (``_LazyHostData``); here
the table is the lazy unit, so that ``Column.data`` stays a plain tensor
on every op's path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.tracing import annotate, trace_op
from .column import Column, resolve_device


class Deferred:
    """A column not decoded yet: ``length`` rows that ``load()`` reads from
    their source as a pyarrow array, built into a Column on ``device`` at
    its first use and kept. ``np_dtype`` is the numpy dtype the column
    will have, from the source's schema."""

    __slots__ = ("length", "load", "device", "np_dtype", "_column")

    def __init__(self, length: int, load: Callable, device, np_dtype: np.dtype):
        self.length = int(length)
        self.load = load
        self.device = device
        self.np_dtype = np_dtype
        self._column: Optional[Column] = None

    def column(self) -> Column:
        if self._column is None:
            self._column = Column.from_arrow(self.load(), self.device)
            self.load = None
        return self._column

    def to_arrow(self):
        return self._column.to_arrow() if self._column is not None else self.load()

    def to_numpy(self) -> np.ndarray:
        if self._column is not None:
            return self._column.to_numpy()
        return Column.from_arrow(self.load(), device="cpu").to_numpy()


class Table:
    __slots__ = ("_columns",)

    def __init__(self, columns: Dict[str, Column]):
        self._columns = dict(columns)
        lens = {c.length for c in self._columns.values()}
        assert len(lens) <= 1, f"ragged table: {lens}"

    @property
    def names(self) -> List[str]:
        return list(self._columns.keys())

    @property
    def columns(self) -> List[Column]:
        return [self[n] for n in self._columns]

    @property
    def device(self) -> Optional[torch.device]:
        """The device of the table's first column, decoded or not (a
        deferred column is not decoded to learn it); None without columns."""
        for c in self._columns.values():
            return torch.device(c.device)
        return None

    def undecoded(self) -> List[str]:
        """Names of the deferred columns no access has decoded yet."""
        return [n for n, c in self._columns.items()
                if isinstance(c, Deferred) and c._column is None]

    @property
    def num_rows(self) -> int:
        for c in self._columns.values():
            return c.length
        return 0

    @property
    def num_columns(self) -> int:
        return len(self._columns)

    def __len__(self) -> int:
        return self.num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> Column:
        c = self._columns[name]
        if isinstance(c, Deferred):
            c = self._columns[name] = c.column()
        return c

    def __iter__(self):
        return ((n, self[n]) for n in list(self._columns))

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(f"{k}: {getattr(v, 'dtype', 'deferred')}"
                         for k, v in self._columns.items())
        return f"Table[{self.num_rows} rows]({cols})"

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self._columns[n] for n in names})

    def drop(self, names: Sequence[str]) -> "Table":
        drop = set(names)
        return Table({n: c for n, c in self._columns.items() if n not in drop})

    def with_column(self, name: str, col: Column) -> "Table":
        """Add ``col`` as ``name``, or replace the column of that name in
        its place."""
        cols = dict(self._columns)
        cols[name] = col
        return Table(cols)

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._columns.items()})

    def slice(self, offset: int, length: Optional[int] = None) -> "Table":
        return Table({n: c.slice(offset, length) for n, c in self})

    # ----------------------------------------------------------------- inter
    @classmethod
    @trace_op
    def from_pandas(cls, df, device=None) -> "Table":
        """Ingest a pandas frame. Floats keep NaN as a value (cudf
        semantics); pandas nullable extension dtypes become a validity
        mask; object/string columns become sorted-dictionary codes."""
        dev = resolve_device(device)
        cols = {}
        for name in df.columns:
            s = df[name]
            with annotate(f"from_pandas.{s.dtype}"):
                cols[str(name)] = _column_from_pandas(s, dev)
        return cls(cols)

    @classmethod
    def from_pydict(cls, d: Dict[str, object], device=None) -> "Table":
        """Columns from a dict of Columns or sequences; ``None`` in an
        object sequence is a null."""
        dev = resolve_device(device)
        cols = {}
        for k, v in d.items():
            if isinstance(v, Column):
                cols[k] = v
                continue
            arr = np.asarray(v)
            validity = None
            if arr.dtype == object:
                valid = np.array([x is not None for x in v], dtype=bool)
                validity = None if valid.all() else valid
            cols[k] = Column.from_numpy(arr, validity, device=dev)
        return cls(cols)

    @classmethod
    def from_host_buffers(cls, cols: Dict[str, dict], device=None) -> "Table":
        """Table from padded host buffers, one dict per column (see
        ``Column.from_host_buffer``): the padded layout of another
        in-memory table carried over as it is, dictionary codes included."""
        dev = resolve_device(device)
        return cls({n: Column.from_host_buffer(spec, dev)
                    for n, spec in cols.items()})

    @classmethod
    def from_arrow(cls, tbl, device=None) -> "Table":
        """Ingest a pyarrow Table (``Column.from_arrow`` per column)."""
        dev = resolve_device(device)
        return cls({name: Column.from_arrow(tbl.column(name), dev)
                    for name in tbl.column_names})

    def to_pandas(self):
        from ..utils.real_pandas import pd
        from .categorical import is_categorical, to_pandas_categorical

        return pd.DataFrame({
            n: (to_pandas_categorical(c) if isinstance(c, Column) and is_categorical(c)
                else c.to_numpy())
            for n, c in self._columns.items()})

    def to_arrow(self):
        import pyarrow as pa

        return pa.table({n: c.to_arrow() for n, c in self._columns.items()})


def _column_from_pandas(s, dev) -> Column:
    """One pandas Series as a column (``Table.from_pandas``'s rules)."""
    from ..utils.real_pandas import pd

    if str(s.dtype) == "category":
        from .categorical import from_pandas_categorical

        return from_pandas_categorical(s.values, dev)
    if isinstance(s.dtype, pd.api.extensions.ExtensionDtype) and str(s.dtype) != "string":
        isnull = s.isna().to_numpy()
        base = getattr(s.dtype, "numpy_dtype", None) or np.dtype("O")
        try:
            vals = s.to_numpy(dtype=base, na_value=0)
        except (TypeError, ValueError):
            vals = s.fillna(0).to_numpy()
        return Column.from_numpy(np.asarray(vals), validity=~isnull if isnull.any() else None,
                                 device=dev)
    vals = s.to_numpy()
    if vals.dtype.kind == "f":
        return Column.from_numpy(vals, device=dev)
    isnull = s.isna().to_numpy()
    return Column.from_numpy(vals, validity=~isnull if isnull.any() else None, device=dev)


def tables_equal(a: "Table", b: "Table") -> bool:
    """pylibcudf.table_equality analog: the same names, row count and
    dtypes, and every row equal: both cells missing (a null, or a NaN in a
    float column) or both holding one value. String cells compare by
    value, across dictionaries; one comparison on the device a column."""
    if list(a.names) != list(b.names) or a.num_rows != b.num_rows:
        return False
    n = a.num_rows
    for ca, cb in zip(a.columns, b.columns):
        if ca.dtype != cb.dtype:
            return False
        da, db = ca.data[:n], cb.data[:n].to(ca.device)
        if ca.dtype.is_string and not np.array_equal(ca.dictionary, cb.dictionary):
            pos = np.searchsorted(ca.dictionary, cb.dictionary)
            hit = pos < len(ca.dictionary)
            hit[hit] = ca.dictionary[pos[hit]] == cb.dictionary[hit]
            remap = torch.as_tensor(np.where(hit, pos, -1), device=ca.device)
            db = remap[db.to(torch.int64)].to(da.dtype) if len(remap) else db
        miss_a = ~ca.valid_mask()[:n]
        miss_b = ~cb.valid_mask()[:n].to(ca.device)
        if ca.dtype.is_floating:
            miss_a |= torch.isnan(da)
            miss_b |= torch.isnan(db)
        same = (miss_a == miss_b) & (miss_a | (da == db))
        if not bool(same.all()):
            return False
    return True
