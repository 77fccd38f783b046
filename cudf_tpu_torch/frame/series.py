"""Series: a labeled column with the pandas surface (counterpart of
``cudf_tpu/frame/series.py``).

Analog of cudf.Series (reference: python/cudf/cudf/core/series.py:432).
Operations align by position; a Series built from pandas keeps its index
(``frame/index.py``). Every op runs on the device of the Series' column;
the constructor takes ``device=None``, which means CUDA and raises
without it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column, resolve_device
from ..ops import binaryop, datetime as dt_ops, reductions, sorting, strings as str_ops
from ..ops import unaryop
from ..ops.stream_compaction import filter_column
from ..utils.padding import bucket_capacity

def _column_from_values(data, dev) -> Column:
    """A column from host values; ``None`` is a null, and a numeric
    sequence with ``None`` becomes float64 with NaN (pandas' inference)."""
    arr = np.asarray(data)
    if arr.dtype != object:
        return Column.from_numpy(arr, device=dev)
    validity = np.array([x is not None for x in data], dtype=bool)
    numeric = all(isinstance(x, (int, float, np.integer, np.floating))
                  and not isinstance(x, bool) for x in data if x is not None)
    if numeric and not validity.all():
        arr = np.array([np.nan if x is None else float(x) for x in data], np.float64)
        return Column.from_numpy(arr, device=dev)
    return Column.from_numpy(arr, None if validity.all() else validity, device=dev)


def take_indices(indices, n: int, device) -> torch.Tensor:
    """Row positions as a gather map of ``n``'s capacity bucket."""
    idx = torch.zeros(bucket_capacity(max(n, 1)), dtype=torch.int64, device=device)
    idx[:n] = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    return idx


class Series:
    __slots__ = ("_col", "name", "_index")

    def __init__(self, data=None, name: Optional[str] = None,
                 column: Optional[Column] = None, index=None, device=None):
        self._index = index
        if column is not None:
            self._col = column
        elif isinstance(data, Series):
            self._col = data._col
            self._index = data._index if index is None else index
        elif isinstance(data, Column):
            self._col = data
        else:
            from ..utils.real_pandas import pd

            dev = resolve_device(device)
            if isinstance(data, pd.Series):
                from . import index as index_mod

                self._index = index_mod.from_pandas(data.index, dev)
                name = name if name is not None else data.name
                if str(data.dtype) == "category":
                    from ..core.categorical import from_pandas_categorical

                    self._col = from_pandas_categorical(data.values, dev)
                    self.name = name
                    return
                vals = data.to_numpy()
                isnull = data.isna().to_numpy()
                keep_nan = vals.dtype.kind == "f"  # NaN stays a value (cuDF)
                self._col = Column.from_numpy(
                    vals, ~isnull if isnull.any() and not keep_nan else None, device=dev)
            else:
                self._col = _column_from_values(data, dev)
        self.name = name

    def _new(self, col: Column, keep_index: bool = False) -> "Series":
        return Series(column=col, name=self.name,
                      index=self._index if keep_index else None)

    # ------------------------------------------------------------------ meta
    @property
    def column(self) -> Column:
        return self._col

    @property
    def device(self) -> torch.device:
        return self._col.device

    def __len__(self):
        return self._col.length

    @property
    def dtype(self):
        return dtypes.to_numpy(self._col.dtype)

    @property
    def values(self):
        return self.to_numpy()

    def __repr__(self):  # pragma: no cover
        return f"Series({self.to_pandas().__repr__()})"

    # ----------------------------------------------------------------- maths
    def _binop(self, other, op, reflect=False):
        rhs = other._col if isinstance(other, Series) else other
        if reflect:
            out = binaryop.binary_op(rhs, self._col, op)
        else:
            out = binaryop.binary_op(self._col, rhs, op)
        return self._new(out)

    def __add__(self, o):
        return self._binop(o, "add")

    def __radd__(self, o):
        return self._binop(o, "add", True)

    def __sub__(self, o):
        return self._binop(o, "sub")

    def __rsub__(self, o):
        return self._binop(o, "sub", True)

    def __mul__(self, o):
        return self._binop(o, "mul")

    def __rmul__(self, o):
        return self._binop(o, "mul", True)

    def __truediv__(self, o):
        return self._binop(o, "div")

    def __rtruediv__(self, o):
        return self._binop(o, "div", True)

    def __floordiv__(self, o):
        return self._binop(o, "floordiv")

    def __mod__(self, o):
        return self._binop(o, "mod")

    def __pow__(self, o):
        return self._binop(o, "pow")

    def __eq__(self, o):  # type: ignore[override]
        return self._binop(o, "eq")

    def __ne__(self, o):  # type: ignore[override]
        return self._binop(o, "ne")

    def __lt__(self, o):
        return self._binop(o, "lt")

    def __le__(self, o):
        return self._binop(o, "le")

    def __gt__(self, o):
        return self._binop(o, "gt")

    def __ge__(self, o):
        return self._binop(o, "ge")

    def __and__(self, o):
        return self._binop(o, "and")

    def __or__(self, o):
        return self._binop(o, "or")

    def __invert__(self):
        return self._new(unaryop.unary_op(self._col, "not"))

    def __neg__(self):
        return self._new(unaryop.unary_op(self._col, "neg"))

    def __abs__(self):
        return self.abs()

    def abs(self):
        return self._new(unaryop.unary_op(self._col, "abs"))

    def round(self, decimals=0):
        return self._new(unaryop.round_col(self._col, decimals))

    def __hash__(self):
        raise TypeError("unhashable")

    # named arithmetic and comparison (python/cudf's flexible binops)
    def add(self, o):
        return self._binop(o, "add")

    def radd(self, o):
        return self._binop(o, "add", True)

    def sub(self, o):
        return self._binop(o, "sub")

    def rsub(self, o):
        return self._binop(o, "sub", True)

    def mul(self, o):
        return self._binop(o, "mul")

    def rmul(self, o):
        return self._binop(o, "mul", True)

    def div(self, o):
        return self._binop(o, "div")

    truediv = div

    def rtruediv(self, o):
        return self._binop(o, "div", True)

    rdiv = rtruediv

    def floordiv(self, o):
        return self._binop(o, "floordiv")

    def rfloordiv(self, o):
        return self._binop(o, "floordiv", True)

    def mod(self, o):
        return self._binop(o, "mod")

    def rmod(self, o):
        return self._binop(o, "mod", True)

    def pow(self, o):
        return self._binop(o, "pow")

    def rpow(self, o):
        return self._binop(o, "pow", True)

    def eq(self, o):
        return self._binop(o, "eq")

    def ne(self, o):
        return self._binop(o, "ne")

    def lt(self, o):
        return self._binop(o, "lt")

    def le(self, o):
        return self._binop(o, "le")

    def gt(self, o):
        return self._binop(o, "gt")

    def ge(self, o):
        return self._binop(o, "ge")

    # ------------------------------------------------------------ predicates
    def isna(self):
        c = unaryop.is_null(self._col)
        if self._col.dtype.is_floating:
            c = binaryop.binary_op(c, unaryop.is_nan(self._col), "or")
        return self._new(c)

    isnull = isna

    def notna(self):
        return ~self.isna()

    notnull = notna

    def isin(self, values):
        """cudf::contains(haystack=values, needles=self); numbers of two
        dtypes compare as f64 (pandas: 1.0 matches 1)."""
        from ..ops.search import contains

        hay = values if isinstance(values, Series) else Series(list(values),
                                                               device=self.device)
        hc, nc = hay._col, self._col
        if hc.dtype.is_numeric and nc.dtype.is_numeric and hc.dtype != nc.dtype:
            hc = unaryop.cast(hc, dtypes.float64)
            nc = unaryop.cast(nc, dtypes.float64)
        return self._new(contains(hc, nc), keep_index=True)

    def between(self, lo, hi, inclusive="both"):
        if inclusive == "both":
            return (self >= lo) & (self <= hi)
        return (self > lo) & (self < hi)

    # ------------------------------------------------------------ transforms
    def fillna(self, value):
        col = self._col
        if col.dtype.is_floating:
            col = unaryop.nans_to_nulls(col)
        return self._new(unaryop.replace_nulls(col, value))

    def astype(self, dtype):
        from ..core import categorical as cat_mod

        if isinstance(dtype, str) and dtype == "category":
            if cat_mod.is_categorical(self._col):
                return self
            return self._new(cat_mod.from_column(self._col))
        if cat_mod.is_categorical(self._col):
            # decode first (pandas: categorical -> values, then cast)
            return Series(column=cat_mod.decode(self._col), name=self.name).astype(dtype)
        np_dt = np.dtype(object) if isinstance(dtype, str) and dtype == "str" else np.dtype(dtype)
        return self._new(unaryop.cast(self._col, dtypes.from_numpy(np_dt)))

    @property
    def cat(self):
        from ..core import categorical as cat_mod

        if not cat_mod.is_categorical(self._col):
            raise AttributeError("not a categorical Series")
        return _CategoricalAccessor(self)

    def where(self, cond, other=np.nan):
        """self where cond, else other (cudf::copy_if_else)."""
        from ..ops.copying import copy_if_else

        c = cond._col if isinstance(cond, Series) else cond
        o = other._col if isinstance(other, Series) else other
        return self._new(copy_if_else(self._col, o, c), keep_index=True)

    def mask(self, cond, other=np.nan):
        inv = ~cond if isinstance(cond, Series) else ~np.asarray(cond)
        return self.where(inv, other)

    def clip(self, lower=None, upper=None):
        out = self
        if lower is not None:
            out = out.where(~out._binop(lower, "lt"), lower)
        if upper is not None:
            out = out.where(~out._binop(upper, "gt"), upper)
        return out

    def replace(self, to_replace, value=None):
        if isinstance(to_replace, dict):
            keys, vals = list(to_replace.keys()), list(to_replace.values())
        else:
            keys = to_replace if isinstance(to_replace, (list, tuple)) else [to_replace]
            vals = value if isinstance(value, (list, tuple)) else [value] * len(keys)
        return self._new(unaryop.find_and_replace(self._col, keys, vals))

    @property
    def index(self):
        from .index import RangeIndex

        return (self._index if self._index is not None
                else RangeIndex(len(self), device=self.device))

    def reset_index(self, drop=True):
        return Series(column=self._col, name=self.name)

    def _rows(self, offset: int, n: int) -> "Series":
        """Rows [offset, offset + n) with their labels (pandas)."""
        from .dataframe import _sliced_index

        return Series(column=self._col.slice(offset, n), name=self.name,
                      index=_sliced_index(self._index, offset, n, self.device))

    def head(self, n=5):
        return self._rows(0, min(n, len(self)))

    def tail(self, n=5):
        off = max(0, len(self) - n)
        return self._rows(off, len(self) - off)

    def _permuted(self, perm) -> "Series":
        from ..ops.copying import gather

        idx = self._index.take(perm, len(self)) if self._index is not None else None
        return Series(column=gather(self._col, perm, len(self)), name=self.name, index=idx)

    def sort_values(self, ascending=True, na_position="last"):
        if self._index is None:
            return self._new(sorting.sort_column(self._col, not ascending,
                                                 na_position == "last"))
        return self._permuted(sorting.sorted_order([self._col], not ascending,
                                                   na_position == "last"))

    def sort_index(self, ascending=True):
        if self._index is None:
            return self
        return self._permuted(sorting.sorted_order(self._index.columns(), not ascending))

    def dropna(self):
        from .index import Index, MultiIndex

        mask = self.notna()._col
        idx = None
        if isinstance(self._index, MultiIndex):
            idx = MultiIndex([filter_column(c, mask) for c in self._index.levels],
                             self._index.names)
        elif self._index is not None:
            idx = Index(filter_column(self._index.columns()[0], mask),
                        getattr(self._index, "name", None))
        return Series(column=filter_column(self._col, mask), name=self.name, index=idx)

    def unique(self):
        from ..core.table import Table
        from ..ops.stream_compaction import distinct

        return self._new(distinct(Table({"v": self._col}))["v"])

    def nunique(self) -> int:
        """Distinct values, nulls and NaN not counted (pandas dropna=True)."""
        from ..ops.stream_compaction import unique_count

        return unique_count([filter_column(self._col, self.notna()._col)])

    def value_counts(self, ascending=False):
        """pandas semantics: a count Series indexed by the values."""
        from ..core.table import Table
        from ..ops.groupby import AggSpec, groupby_aggregate
        from .index import Index

        g = groupby_aggregate(Table({"v": self._col}), ["v"], [AggSpec("", "size", "count")])
        g = sorting.sort_by_key(g, ["count"], descending=not ascending)
        return Series(column=g["count"], name="count", index=Index(g["v"], self.name))

    def cumsum(self):
        return self._new(reductions.scan(self._col, "cumsum"))

    def cummax(self):
        return self._new(reductions.scan(self._col, "cummax"))

    def cummin(self):
        return self._new(reductions.scan(self._col, "cummin"))

    def cumprod(self):
        return self._new(reductions.scan(self._col, "cumprod"))

    def rank(self, method="average", ascending=True, pct=False):
        return self._new(sorting.rank(self._col, method, not ascending, pct))

    def __getitem__(self, key):
        if isinstance(key, Series):
            return self._new(filter_column(self._col, key._col))
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step != 1:
                raise NotImplementedError("a slice with a step")
            return self._rows(start, stop - start)
        return self.to_numpy()[key]

    # ------------------------------------------------------------ reductions
    def _nan_as_null(self) -> Column:
        """pandas skipna: NaN counts as missing."""
        c = self._col
        return unaryop.nans_to_nulls(c) if c.dtype.is_floating else c

    def _reduce(self, kind, param=0.0, col: Optional[Column] = None):
        return reductions.to_scalar(reductions.reduce(
            self._col if col is None else col, kind, param))

    def sum(self):
        v = self._reduce("sum", col=self._nan_as_null())
        return 0 if v is None else v

    def mean(self):
        return self._reduce("mean", col=self._nan_as_null())

    def min(self):
        return self._reduce("min", col=self._nan_as_null())

    def max(self):
        return self._reduce("max", col=self._nan_as_null())

    def count(self):
        return self._reduce("count", col=self._nan_as_null())

    def var(self, ddof=1):
        return self._reduce("var", ddof, col=self._nan_as_null())

    def std(self, ddof=1):
        return self._reduce("std", ddof, col=self._nan_as_null())

    def median(self):
        return self._reduce("median", col=self._nan_as_null())

    def quantile(self, q=0.5):
        return self._reduce("quantile", q, col=self._nan_as_null())

    def any(self):
        return bool(self._reduce("any"))

    def all(self):
        return bool(self._reduce("all"))

    def prod(self):
        v = self._reduce("product")
        return 1 if v is None else v

    def argmin(self):
        return self._reduce("argmin")

    def argmax(self):
        return self._reduce("argmax")

    def idxmax(self):
        return int(self.argmax())

    def idxmin(self):
        return int(self.argmin())

    # --------------------------------------------------------------- windows
    def shift(self, periods=1):
        from ..ops.rolling import shift as _shift

        return self._new(_shift(self._col, periods))

    def diff(self, periods=1):
        from ..ops.rolling import diff as _diff

        return self._new(_diff(self._col, periods))

    def pct_change(self, periods=1):
        prev = self.shift(periods)
        return (self - prev) / prev

    def rolling(self, window, min_periods=None, center=False):
        return _Rolling(self, window, min_periods, center)

    def ewm(self, alpha=None, adjust=True, **kw):
        return _EWM(self, alpha, adjust)

    def ffill(self):
        from ..ops.filling import fill_forward

        return self._new(fill_forward(self._col), keep_index=True)

    def bfill(self):
        from ..ops.filling import fill_backward

        return self._new(fill_backward(self._col), keep_index=True)

    def searchsorted(self, other, side="left"):
        from ..ops.search import searchsorted as _ss

        oc = other._col if isinstance(other, Series) else Series(other, device=self.device)._col
        return self._new(_ss(self._col, oc, side))

    # ---------------------------------------------------- pandas long tail
    def take(self, indices):
        """Rows by position, with their labels (pandas)."""
        from ..ops.copying import gather

        n = len(indices)
        idx = take_indices(indices, n, self.device)
        return Series(column=gather(self._col, idx, n), name=self.name,
                      index=self.index.take(idx, n))

    def map(self, arg):
        """dict or callable mapping, evaluated on the host (python/cudf
        Series.map's dictionary path)."""
        vals = self.to_numpy()
        if callable(arg):
            out = np.array([arg(v) for v in vals], dtype=object)
        else:
            get = arg.get if hasattr(arg, "get") else dict(arg).get
            out = np.array([get(v, np.nan) for v in vals], dtype=object)
        try:
            out = out.astype(np.float64)
        except (TypeError, ValueError):
            pass
        return Series(out, name=self.name, index=self._index, device=self.device)

    def mode(self):
        vc = self.value_counts()
        n = vc.to_numpy()
        top = n.max() if len(n) else 0
        vals = np.sort(vc._index.to_pandas().to_numpy()[n == top])
        return Series(vals, name=self.name, device=self.device)

    def duplicated(self, keep="first"):
        from ..core.table import Table
        from ..ops.stream_compaction import distinct_mask

        m = distinct_mask(Table({"v": self._col}), keep=keep)
        return self._new(Column(dtypes.bool_, ~m.data, None, m.length))

    def drop_duplicates(self, keep="first"):
        from ..core.table import Table
        from ..ops.stream_compaction import distinct

        return self._new(distinct(Table({"v": self._col}), keep=keep)["v"])

    def nlargest(self, n=5):
        return self._new(sorting.sort_column(self._col, True).slice(0, min(n, len(self))))

    def nsmallest(self, n=5):
        return self._new(sorting.sort_column(self._col, False).slice(0, min(n, len(self))))

    def _present(self):
        """(values as f64, bool mask of the rows that are neither null nor
        NaN), on the Series' device (pandas skipna)."""
        if not self._col.dtype.is_numeric:
            raise TypeError(f"a moment of a non-numeric Series ({self._col.dtype})")
        x = self._col.data.to(torch.float64)
        return x, self._col.valid_mask() & ~torch.isnan(x)

    def _central_sums(self, powers):
        """(count, [Σ(x - mean)^p for p in powers]) over the present rows, in
        pandas nanops' arithmetic: d², d²·d and (d²)², with a sum below its
        round-off floor taken as 0. The count is a float of the column's
        width, as in pandas, so a float32 column's factors round as there."""
        x, ok = self._present()
        n = int(ok.sum())
        xs = torch.where(ok, x, 0.0)
        d = torch.where(ok, xs - xs.sum() / max(n, 1), 0.0)
        d2 = d * d
        terms = {2: d2, 3: d2 * d, 4: d2 * d2}
        floor = np.finfo(np.float64).eps * (float(xs.abs().max()) if n else 0.0)
        sums = [np.float64(terms[p].sum()) for p in powers]
        sums = [np.float64(0.0) if abs(v) < floor ** p * n else v
                for v, p in zip(sums, powers)]
        f32 = self._col.dtype.physical == torch.float32
        return (np.float32 if f32 else np.float64)(n), sums

    def _in_own_width(self, v) -> float:
        return float(np.float32(v) if self._col.dtype.physical == torch.float32 else v)

    def skew(self):
        """pandas nanskew: the adjusted Fisher-Pearson coefficient."""
        n, (m2, m3) = self._central_sums((2, 3))
        if n < 3:
            return np.nan
        if m2 == 0:
            return 0.0
        return self._in_own_width((n * (n - 1) ** 0.5 / (n - 2)) * (m3 / m2 ** 1.5))

    def kurt(self):
        """pandas nankurt: the excess kurtosis, bias-corrected."""
        n, (m2, m4) = self._central_sums((2, 4))
        if n < 4:
            return np.nan
        adj = 3 * (n - 1) ** 2 / ((n - 2) * (n - 3))
        num = n * (n + 1) * (n - 1) * m4
        den = (n - 2) * (n - 3) * m2 ** 2
        if den == 0:
            return 0.0
        return self._in_own_width(num / den - adj)

    kurtosis = kurt

    def sem(self, ddof=1):
        n = self.count()
        return float(self.std(ddof) / np.sqrt(n)) if n else np.nan

    def _pair_sums(self, other):
        """(count, Σ da·db, Σ da², Σ db²) over the rows where both Series,
        taken by position, are present; d is the deviation from the mean of
        those rows."""
        a, oka = self._present()
        b, okb = other._present()
        ok = oka & okb
        n = int(ok.sum())
        a, b = torch.where(ok, a, 0.0), torch.where(ok, b, 0.0)
        da = torch.where(ok, a - a.sum() / max(n, 1), 0.0)
        db = torch.where(ok, b - b.sum() / max(n, 1), 0.0)
        return n, float((da * db).sum()), float((da * da).sum()), float((db * db).sum())

    def corr(self, other):
        """Pearson correlation over the rows where both are present."""
        n, ab, aa, bb = self._pair_sums(other)
        if n < 2:
            return np.nan
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.clip(np.float64(ab) / np.sqrt(np.float64(aa) * bb), -1.0, 1.0))

    def cov(self, other):
        """Sample covariance (ddof 1) over the rows where both are present."""
        n, ab, _, _ = self._pair_sums(other)
        return ab / (n - 1) if n > 1 else np.nan

    def combine_first(self, other):
        return self.where(self.notna(), other)

    def sample(self, n=None, frac=None, random_state=None):
        rng = np.random.default_rng(random_state)
        k = n if n is not None else max(1, int(len(self) * (frac or 1.0)))
        return self.take(np.sort(rng.choice(len(self), size=min(k, len(self)),
                                            replace=False)))

    def repeat(self, repeats):
        """Each row ``repeats`` times (a count, or one per row), under a
        fresh RangeIndex as in the reference."""
        from ..ops.copying import gather

        n = len(self)
        reps = torch.as_tensor(np.broadcast_to(np.asarray(repeats, np.int64), (n,)).copy(),
                               device=self.device)
        idx = torch.repeat_interleave(torch.arange(n, device=self.device), reps)
        out_n = idx.numel()
        cap = torch.zeros(bucket_capacity(max(out_n, 1)), dtype=torch.int64,
                          device=self.device)
        cap[:out_n] = idx
        return Series(column=gather(self._col, cap, out_n), name=self.name)

    def rename(self, name):
        return Series(column=self._col, name=name, index=self._index)

    def copy(self, deep=False):
        return Series(column=self._col, name=self.name, index=self._index)

    def drop(self, labels=None):
        lab = labels if isinstance(labels, (list, tuple, np.ndarray)) else [labels]
        idx = (self._index.to_pandas().to_numpy() if self._index is not None
               else np.arange(len(self)))
        return self.take(np.flatnonzero(~np.isin(idx, np.asarray(lab))))

    def describe(self):
        """pandas describe from device reductions: count, mean, std, min,
        quartiles and max for numbers; count, unique, top (the most frequent
        value, the first to appear among equals) and freq otherwise."""
        from ..utils.real_pandas import pd

        if self._col.dtype.is_numeric and self._col.dtype.kind != dtypes.Kind.BOOL:
            stats = [float(self.count()), self.mean(), self.std(), self.min(),
                     self.quantile(0.25), self.quantile(0.5), self.quantile(0.75),
                     self.max()]
            return pd.Series([np.nan if v is None else float(v) for v in stats],
                             index=["count", "mean", "std", "min", "25%", "50%", "75%",
                                    "max"], name=self.name)
        from ..core.table import Table
        from ..ops.filling import sequence
        from ..ops.groupby import AggSpec, groupby_aggregate

        g = groupby_aggregate(Table({"v": self._col,
                                     "pos": sequence(len(self), device=self.device)}),
                              ["v"], [AggSpec("", "size", "n"), AggSpec("pos", "min", "at")])
        m = g.num_rows
        cnt, at = g["n"].data[:m], g["at"].data[:m]
        if m == 0:
            top, freq = np.nan, np.nan
        else:
            freq = int(cnt.max())
            first = torch.where(cnt == freq, at, torch.iinfo(at.dtype).max)
            top = g["v"].slice(int(torch.argmin(first)), 1).to_numpy()[0]
        return pd.Series([int(self.count()), m, top, freq],
                         index=["count", "unique", "top", "freq"], dtype=object,
                         name=self.name)

    def explode(self, ignore_index=False):
        """``DataFrame.explode`` on this Series alone (pandas semantics)."""
        from ..core.table import Table
        from .dataframe import DataFrame

        out = DataFrame._from_table(Table({"v": self._col}), self._index).explode(
            "v", ignore_index)
        return Series(column=out._tbl["v"], name=self.name, index=out._index)

    def pipe(self, func, *a, **kw):
        return func(self, *a, **kw)

    def items(self):
        vals = self.to_numpy()
        idx = (self._index.to_pandas().to_numpy() if self._index is not None
               else np.arange(len(vals)))
        return iter(zip(idx, vals))

    def to_frame(self, name=None):
        from ..core.table import Table
        from .dataframe import DataFrame

        return DataFrame._from_table(Table({name or self.name or 0: self._col}),
                                     index=self._index)

    def to_list(self):
        return list(self.to_numpy())

    tolist = to_list

    def to_dict(self):
        return dict(self.items())

    @property
    def iloc(self):
        return _SeriesILoc(self)

    @property
    def loc(self):
        return _SeriesILoc(self)  # positional for default indexes

    # ------------------------------------------------------------- accessors
    @property
    def str(self):
        return _StringAccessor(self)

    @property
    def dt(self):
        return _DatetimeAccessor(self)

    # --------------------------------------------------------------- export
    def to_numpy(self):
        return self._col.to_numpy()

    def to_pandas(self):
        out = self._col.to_pandas(name=self.name)
        if self._index is not None:
            out.index = self._index.to_pandas()
        return out

    def to_arrow(self):
        return self._col.to_arrow()


class _CategoricalAccessor:
    """pandas Series.cat (python/cudf/cudf/core/column/categorical.py
    CategoricalAccessor)."""

    def __init__(self, s: Series):
        from ..core import categorical as cat_mod

        self._s = s
        self._m = cat_mod

    def _wrap(self, col):
        return Series(column=col, name=self._s.name)

    @property
    def categories(self):
        return list(self._s._col.dictionary)

    @property
    def ordered(self) -> bool:
        return self._m.ordered(self._s._col)

    @property
    def codes(self):
        return self._wrap(self._m.codes_column(self._s._col))

    def set_categories(self, new_categories, ordered=None):
        return self._wrap(self._m.set_categories(self._s._col, new_categories, ordered))

    def add_categories(self, new_categories):
        return self._wrap(self._m.add_categories(self._s._col, new_categories))

    def remove_categories(self, removals):
        return self._wrap(self._m.remove_categories(self._s._col, removals))

    def rename_categories(self, mapping):
        return self._wrap(self._m.rename_categories(self._s._col, mapping))

    def reorder_categories(self, new_categories, ordered=None):
        return self._wrap(self._m.reorder_categories(self._s._col, new_categories,
                                                     ordered))

    def as_ordered(self):
        return self._wrap(self._m.as_ordered(self._s._col, True))

    def as_unordered(self):
        return self._wrap(self._m.as_ordered(self._s._col, False))


class _StringAccessor:
    """Series.str over the ported string ops (``ops/strings.py``)."""

    def __init__(self, s: Series):
        self._s = s

    def _wrap(self, col):
        return Series(column=col, name=self._s.name)

    def lower(self):
        return self._wrap(str_ops.lower(self._s._col))

    def upper(self):
        return self._wrap(str_ops.upper(self._s._col))

    def capitalize(self):
        return self._wrap(str_ops.capitalize(self._s._col))

    def strip(self):
        return self._wrap(str_ops.strip(self._s._col))

    def contains(self, pat, regex=True):
        return self._wrap(str_ops.contains(self._s._col, pat, regex))

    def startswith(self, pat):
        return self._wrap(str_ops.startswith(self._s._col, pat))

    def endswith(self, pat):
        return self._wrap(str_ops.endswith(self._s._col, pat))

    def match_like(self, pattern):
        return self._wrap(str_ops.match_like(self._s._col, pattern))

    def len(self):
        return self._wrap(str_ops.len_strings(self._s._col))

    def slice(self, start=None, stop=None, step=None):
        return self._wrap(str_ops.slice_strings(self._s._col, start, stop, step))

    def cat(self, others=None, sep=""):
        cols = [self._s._col] + [o._col if isinstance(o, Series) else o
                                 for o in (others or [])]
        return self._wrap(str_ops.concat_strings(cols, sep))

    def extract(self, pat, expand=False, group=1):
        """The first capture group; expand=True gives a one-column frame."""
        out = self._wrap(str_ops.extract_re(self._s._col, pat, group))
        if expand:
            from ..core.table import Table
            from .dataframe import DataFrame

            return DataFrame._from_table(Table({"0": out._col}))
        return out

    def replace(self, pat, repl, regex=True, n=-1):
        return self._wrap(str_ops.replace_str(self._s._col, pat, repl, regex=regex, n=n))

    def count(self, pat):
        return self._wrap(str_ops.count_re(self._s._col, pat))

    def find(self, sub):
        return self._wrap(str_ops.find(self._s._col, sub))

    def split(self, pat=" ", n=-1, expand=False):
        """expand=True: a frame of the parts; expand=False: a Series of
        lists, one a row, held on the device as a ListColumn
        (``strings.split_record``): ``explode`` takes it as it is, and
        ``to_pandas`` gives the lists."""
        from .dataframe import DataFrame

        col = self._s._col
        if expand:
            return DataFrame._from_table(str_ops.split_expand(col, pat, n))
        return Series(column=str_ops.split_record(col, pat, n if n > 0 else -1),
                      name=self._s.name, index=self._s._index)


class _DatetimeAccessor:
    """Series.dt over ``ops/datetime.py``."""

    def __init__(self, s: Series):
        self._s = s

    def _field(self, f):
        return Series(column=dt_ops.extract(self._s._col, f), name=self._s.name)

    @property
    def year(self):
        return self._field("year")

    @property
    def month(self):
        return self._field("month")

    @property
    def day(self):
        return self._field("day")

    @property
    def hour(self):
        return self._field("hour")

    @property
    def minute(self):
        return self._field("minute")

    @property
    def second(self):
        return self._field("second")

    @property
    def weekday(self):
        return self._field("weekday") - 1  # ISO Monday=1 -> pandas Monday=0

    @property
    def dayofyear(self):
        return self._field("day_of_year")


class DataFrameProxy:
    """A DataFrame over a Table: ``DataFrameProxy(tbl)`` builds the
    frame (what ``value_counts`` returns)."""

    def __new__(cls, tbl):
        from .dataframe import DataFrame

        return DataFrame._from_table(tbl)


class _Rolling:
    def __init__(self, s, window, min_periods, center):
        self._s, self._w, self._mp, self._c = s, window, min_periods, center

    def _agg(self, kind):
        from ..ops.rolling import rolling

        return Series(column=rolling(self._s._col, self._w, kind, self._mp, self._c),
                      name=self._s.name)

    def sum(self):
        return self._agg("sum")

    def mean(self):
        return self._agg("mean")

    def min(self):
        return self._agg("min")

    def max(self):
        return self._agg("max")

    def count(self):
        return self._agg("count")

    def var(self):
        return self._agg("var")

    def std(self):
        return self._agg("std")


class _EWM:
    def __init__(self, s, alpha, adjust):
        self._s, self._a, self._adj = s, alpha, adjust

    def mean(self):
        return Series(column=reductions.ewma(self._s._col, self._a, self._adj),
                      name=self._s.name)


class _SeriesILoc:
    """Positional indexer (Series.iloc; loc falls back here)."""

    def __init__(self, s: Series):
        self._s = s

    def __getitem__(self, key):
        s = self._s
        if isinstance(key, slice):
            start, stop, step = key.indices(len(s))
            if step == 1:
                return s._rows(start, stop - start)
            return s.take(np.arange(start, stop, step))
        if isinstance(key, (list, np.ndarray)):
            return s.take(np.asarray(key, np.int64))
        if isinstance(key, Series):
            if key.dtype == np.bool_:
                return s[key]
            return s.take(key.to_numpy().astype(np.int64))
        return s.to_numpy()[int(key)]
