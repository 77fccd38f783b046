"""Table: an ordered mapping of named columns of equal logical length.

Counterpart of ``cudf_tpu/core/table.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .column import Column, resolve_device


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
        return list(self._columns.values())

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
        return self._columns[name]

    def __iter__(self):
        return iter(self._columns.items())

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(f"{k}: {v.dtype}" for k, v in self._columns.items())
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
        return Table({n: c.slice(offset, length) for n, c in self._columns.items()})

    # ----------------------------------------------------------------- inter
    @classmethod
    def from_pandas(cls, df, device=None) -> "Table":
        """Ingest a pandas frame. Floats keep NaN as a value (cudf
        semantics); pandas nullable extension dtypes become a validity
        mask; object/string columns become sorted-dictionary codes."""
        import pandas as pd

        dev = resolve_device(device)
        cols = {}
        for name in df.columns:
            s = df[name]
            if str(s.dtype) == "category":
                raise NotImplementedError(
                    "categorical columns are not ported yet")
            if isinstance(s.dtype, pd.api.extensions.ExtensionDtype) and \
                    str(s.dtype) != "string":
                isnull = s.isna().to_numpy()
                base = getattr(s.dtype, "numpy_dtype", None) or np.dtype("O")
                try:
                    vals = s.to_numpy(dtype=base, na_value=0)
                except (TypeError, ValueError):
                    vals = s.fillna(0).to_numpy()
                cols[str(name)] = Column.from_numpy(
                    np.asarray(vals), validity=~isnull if isnull.any() else None,
                    device=dev)
                continue
            vals = s.to_numpy()
            if vals.dtype.kind == "f":
                cols[str(name)] = Column.from_numpy(vals, device=dev)
            else:
                isnull = s.isna().to_numpy()
                cols[str(name)] = Column.from_numpy(
                    vals, validity=~isnull if isnull.any() else None,
                    device=dev)
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

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({n: c.to_numpy() for n, c in self._columns.items()})
