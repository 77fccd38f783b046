"""DataFrameGroupBy: pandas-like grouped aggregation and grouped windows
(counterpart of ``cudf_tpu/frame/groupby.py``).

Analog of cudf.core.groupby.GroupBy (reference: python/cudf/cudf/core/
groupby/groupby.py:426-463); ``ops/groupby.groupby_aggregate`` is the
engine. pandas semantics on top of it: a NaN value or key is missing
(skipna), a sum or product over a group with no valid value is 0 or 1
(pandas min_count=0), and ``as_index`` sets the keys as the index.
Faults of the reference not copied: its generated ``size`` method calls
itself (a RecursionError), where ``size`` here is the one method defined;
and its window methods carry a NaN value through a group's running sum,
where here, as in pandas, the NaN row is missing and the sum goes on. An f32
value column with NaNs becomes a column with nulls, which the one-hot
kernel lane takes (``fastgroup._onehot_groupby`` with V = 2); one with
neither NaN nor nulls, as ``DataFrame.dropna`` leaves it, stays at V = 1.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.column import Column
from ..core.table import Table
from ..ops.groupby import AggSpec, groupby_aggregate

_METHODS = (
    "sum", "mean", "min", "max", "count", "nunique", "var", "std",
    "median", "first", "last", "any", "all", "product",
)
_NUMERIC_ONLY = ("sum", "mean", "var", "std", "median", "product")


class DataFrameGroupBy:
    def __init__(self, df, keys: List[str], sort=True, dropna=True, value_cols=None,
                 as_index=True, scalar_sel=False):
        self._df = df
        self._keys = keys
        self._sort = sort
        self._dropna = dropna
        self._value_cols = value_cols
        self._as_index = as_index
        # df.groupby(k)["v"] is a SeriesGroupBy: its aggregation is a Series
        self._scalar_sel = scalar_sel

    def __getitem__(self, cols):
        scalar = isinstance(cols, str)
        return DataFrameGroupBy(self._df, self._keys, sort=self._sort,
                                dropna=self._dropna,
                                value_cols=[cols] if scalar else list(cols),
                                as_index=self._as_index, scalar_sel=scalar)

    def _value_columns(self):
        if self._value_cols is not None:
            return self._value_cols
        return [n for n in self._df._tbl.names if n not in self._keys]

    def _run(self, specs):
        from ..ops.unaryop import nans_to_nulls
        from .dataframe import DataFrame
        from .series import Series

        if not self._sort:
            # the engine's output is key-sorted; pandas sort=False keeps the
            # first-appearance order, which it does not give
            raise NotImplementedError("groupby(sort=False)")
        if self._scalar_sel and len(specs) != 1:
            raise TypeError("a selected column takes exactly one aggregation")
        tbl = self._df._tbl
        used = set(self._keys) | {s.column for s in specs if s.column}
        # a NaN is missing; a float column without one keeps its mask or
        # lack of one, so a dropna'd value column takes the one-hot lane at V = 1
        conv = {n for n in used
                if tbl[n].dtype.is_floating and bool(torch.isnan(tbl[n].data).any())}
        if conv:
            tbl = Table({n: (nans_to_nulls(tbl[n]) if n in conv else tbl[n]) for n in used})
        else:
            tbl = tbl.select([n for n in tbl.names if n in used])
        out = groupby_aggregate(tbl, self._keys, specs, self._dropna)
        fill = {"sum": 0, "product": 1}
        fixed = {}
        for s in specs:
            c = out[s.out_name]
            if s.kind in fill and c.validity is not None:
                data = torch.where(c.validity, c.data,
                                   torch.full((), fill[s.kind], dtype=c.data.dtype,
                                              device=c.device))
                fixed[s.out_name] = Column(c.dtype, data, None, c.length, c.dictionary)
        if fixed:
            out = Table({n: fixed.get(n, c) for n, c in out})
        df = DataFrame._from_table(out)
        if self._as_index:
            df = df.set_index(self._keys if len(self._keys) > 1 else self._keys[0])
            if self._scalar_sel:
                name = specs[0].out_name
                return Series(column=df._tbl[name], name=name, index=df._index)
        return df

    def _method(self, kind, param=0.0):
        explicit = self._value_cols is not None
        specs = []
        for n in self._value_columns():
            if kind in _NUMERIC_ONLY and not self._df._tbl[n].dtype.is_numeric:
                if explicit:
                    # a SELECTED non-numeric column is not dropped silently
                    raise TypeError(f"{kind} on non-numeric column {n!r}")
                continue
            specs.append(AggSpec(n, kind, n, param))
        if not specs:
            raise TypeError(f"no aggregatable columns for {kind}")
        return self._run(specs)

    def agg(self, arg=None, **named):
        """agg("sum"), agg({"col": "sum" or [...]}) or agg(out=("col", "mean"))."""
        specs = []
        if arg is not None:
            if isinstance(arg, str):
                return self._method(arg)
            for col_name, how in arg.items():
                hows = [how] if isinstance(how, str) else list(how)
                for h in hows:
                    out_name = col_name if len(hows) == 1 else f"{col_name}_{h}"
                    specs.append(AggSpec(col_name, _norm_kind(h), out_name))
        for out_name, (col_name, how) in named.items():
            kind = _norm_kind(how)
            specs.append(AggSpec(col_name if kind != "size" else "", kind, out_name))
        return self._run(specs)

    aggregate = agg

    def size(self):
        return self._run([AggSpec("", "size", "size")])

    # ---- window methods: one value per row, in the original row order ----
    def _window_col(self, fn, *args):
        """A grouped window over the one selected column; its NaNs are
        missing (pandas' skipna), so a running sum steps over them."""
        from ..ops.unaryop import nans_to_nulls
        from .series import Series

        cols = self._value_columns()
        if len(cols) != 1:
            raise ValueError("select a single column for a window method")
        tbl = self._df._tbl.select(list(dict.fromkeys(self._keys + cols)))
        if tbl[cols[0]].dtype.is_floating:
            tbl = tbl.with_column(cols[0], nans_to_nulls(tbl[cols[0]]))
        return Series(column=fn(tbl, self._keys, cols[0], *args), name=cols[0])

    def shift(self, periods: int = 1):
        from ..ops.grouped_window import grouped_shift

        return self._window_col(grouped_shift, periods)

    def cumsum(self):
        from ..ops.grouped_window import grouped_scan

        return self._window_col(grouped_scan, "cumsum")

    def cumcount(self):
        from ..ops.binaryop import binary_op
        from ..ops.grouped_window import grouped_scan
        from .series import Series

        cols = self._value_columns() or [self._keys[0]]
        out = grouped_scan(self._df._tbl, self._keys, cols[0], "row_number")
        return Series(column=binary_op(out, 1, "sub"), name=None)

    def rolling_agg(self, window: int, kind: str = "sum", min_periods=None):
        from ..ops.grouped_window import grouped_rolling

        return self._window_col(grouped_rolling, window, kind, min_periods)


def _norm_kind(how: str) -> str:
    return {"prod": "product"}.get(how, how)


def _make(kind):
    def fn(self, *a, **k):
        return self._method(kind)
    fn.__name__ = kind
    return fn


for _m in _METHODS:
    setattr(DataFrameGroupBy, _m, _make(_m))
