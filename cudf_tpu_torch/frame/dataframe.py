"""DataFrame: the pandas-like 2-D API over Table (counterpart of
``cudf_tpu/frame/dataframe.py``).

Analog of cudf.DataFrame (reference: python/cudf/cudf/core/dataframe.py:901)
with the reference's index model: a default RangeIndex costs nothing,
row-permuting ops (sorts, filters, dropna, drop_duplicates, query) carry
the original positions as an index column (``_embed_index``) so the result
keeps pandas' permuted index, a slice keeps its rows' positions, merge
results take a fresh RangeIndex, and groupby sets the keys as the index
unless ``as_index=False``.

Faults of the reference not copied: its ``tail``, slices, ``take``,
``iloc`` with a list, ``drop_duplicates`` and ``query`` give a
default-indexed frame a fresh RangeIndex, and its ``Series.nunique`` counts NaN as a value; here they
equal pandas.

Every op runs on the frame's device: that of its columns (a deferred
column's too, read without decoding it), or the one a constructor was
given. A frame over a table read from parquet decodes a column only when
an op reads it: ``len``, ``columns`` and ``dtypes`` decode nothing.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column, resolve_device
from ..core.table import Deferred, Table
from ..ops import copying, join as join_ops, sorting, stream_compaction as sc, unaryop
from .series import _ITEM4, Series, _column_from_values, take_indices


def _unmasked(c: Column) -> Column:
    """``c`` without its validity mask, for a column known to hold no null;
    its stats, a bound on its values, still hold."""
    out = Column(c.dtype, c.data, None, c.length)
    out.stats, out.stats_ref = c.stats, c.stats_ref
    return out


class DataFrame:
    __slots__ = ("_tbl", "_index", "_device")

    def __init__(self, data=None, columns=None, index=None, device=None):
        from ..utils.real_pandas import pd

        self._index = index
        self._device = None
        if isinstance(data, Table):
            self._tbl = data
            return
        dev = resolve_device(device)
        self._device = dev
        if data is None:
            self._tbl = Table({})
        elif isinstance(data, dict):
            cols = {}
            for k, v in data.items():
                if isinstance(v, Series):
                    cols[str(k)] = v._col
                elif isinstance(v, Column):
                    cols[str(k)] = v
                elif np.ndim(v) == 0:
                    raise ValueError("scalar dict values need an explicit length")
                else:
                    cols[str(k)] = _column_from_values(v, dev)
            self._tbl = Table(cols)
        elif isinstance(data, pd.DataFrame):
            from . import index as index_mod

            self._tbl = Table.from_pandas(data.reset_index(drop=True), dev)
            self._index = index_mod.from_pandas(data.index, dev)
        elif isinstance(data, np.ndarray):
            names = columns or [str(i) for i in range(data.shape[1])]
            self._tbl = Table({n: Column.from_numpy(data[:, i], device=dev)
                               for i, n in enumerate(names)})
        else:
            raise TypeError(f"cannot construct DataFrame from {type(data)}")

    @classmethod
    def _from_table(cls, tbl: Table, index=None, device=None) -> "DataFrame":
        out = object.__new__(cls)
        out._tbl = tbl
        out._index = index
        out._device = device
        return out

    @property
    def device(self) -> torch.device:
        dev = self._tbl.device
        return dev if dev is not None else resolve_device(self._device)

    def _like(self, tbl: Table, index=None) -> "DataFrame":
        """A frame on this frame's device (kept when ``tbl`` is empty)."""
        return DataFrame._from_table(tbl, index, self.device)

    # ------------------------------------------------------------- index glue
    # Row-permuting ops run with the index levels appended as reserved
    # columns, so the permutation moves data and labels together (cudf's
    # "index is just columns" Frame model, core/frame.py:60).
    _IDX_PREF = "__cudf_tpu_index_"

    @property
    def index(self):
        from .index import RangeIndex

        return (self._index if self._index is not None
                else RangeIndex(len(self), device=self.device))

    def _embed_index(self, force: bool = False) -> Table:
        """Embed the index levels as prefixed columns. ``force=True`` also
        materializes the default RangeIndex, on the frame's device:
        row-permuting ops carry the original positions, because pandas
        permutes the index with the rows."""
        if self._index is None:
            if not force:
                return self._tbl
            from ..ops.filling import sequence

            return self._tbl.with_column(f"{self._IDX_PREF}0",
                                         sequence(len(self), device=self.device))
        t = self._tbl
        for i, c in enumerate(self._index.columns()):
            t = t.with_column(f"{self._IDX_PREF}{i}", c)
        return t

    def _unembed_index(self, tbl: Table) -> "DataFrame":
        from .index import Index, MultiIndex

        names = [n for n in tbl.names if n.startswith(self._IDX_PREF)]
        if not names:
            return self._like(tbl)
        cols = [tbl[n] for n in names]
        data = tbl.drop(names)
        if isinstance(self._index, MultiIndex):
            idx = MultiIndex(cols, self._index.names)
        else:
            idx = Index(cols[0], getattr(self._index, "name", None))
        return self._like(data, idx)

    def set_index(self, keys, drop=True, append=False):
        """pandas/cudf set_index (single or multi level)."""
        from .index import Index, MultiIndex

        keys = [keys] if isinstance(keys, str) else list(keys)
        levels = [self._tbl[k] for k in keys]
        names = list(keys)
        if append and self._index is not None:
            levels = self._index.columns() + levels
            prev = (self._index.names if isinstance(self._index, MultiIndex)
                    else [getattr(self._index, "name", None)])
            names = list(prev) + names
        tbl = self._tbl.drop(keys) if drop else self._tbl
        idx = Index(levels[0], names[0]) if len(levels) == 1 else MultiIndex(levels, names)
        return self._like(tbl, idx)

    def sort_index(self, ascending=True):
        if self._index is None:
            return self
        perm = sorting.sorted_order(self._index.columns(), descending=not ascending)
        return self._unembed_index(copying.gather_table(self._embed_index(), perm, len(self)))

    @property
    def loc(self):
        return _Loc(self)

    @property
    def iloc(self):
        return _ILoc(self)

    # ------------------------------------------------------------------ meta
    @property
    def table(self) -> Table:
        return self._tbl

    @property
    def columns(self):
        from ..utils.real_pandas import pd

        return pd.Index(self._tbl.names)

    @property
    def shape(self):
        return (self._tbl.num_rows, self._tbl.num_columns)

    @property
    def dtypes(self):
        """Each column's numpy dtype; a deferred column's comes from its
        file's schema, without decoding it."""
        from ..utils.real_pandas import pd

        return pd.Series({n: _np_dtype(c) for n, c in self._tbl._columns.items()})

    def __len__(self):
        return self._tbl.num_rows

    def __contains__(self, k):
        return k in self._tbl

    def __repr__(self):  # pragma: no cover
        return f"DataFrame({self._tbl!r})\n{self.head(5).to_pandas()}"

    # ---------------------------------------------------------------- access
    def __getitem__(self, key):
        if isinstance(key, str):
            return Series(column=self._tbl[key], name=key, index=self._index)
        if isinstance(key, list):
            return self._like(self._tbl.select(key), self._index)
        if isinstance(key, Series):  # boolean mask
            return self._unembed_index(sc.apply_boolean_mask(self._embed_index(force=True),
                                                             key._col))
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step != 1:
                raise NotImplementedError("a slice with a step")
            return self._rows(start, stop - start)
        raise KeyError(key)

    def _rows(self, offset: int, n: int) -> "DataFrame":
        """Rows [offset, offset + n) with their labels: a default index
        becomes the RangeIndex of those positions, as in pandas."""
        idx = _sliced_index(self._index, offset, n, self.device)
        return self._like(self._tbl.slice(offset, n), idx)

    def _as_column(self, value) -> Column:
        if isinstance(value, Series):
            return value._col
        if isinstance(value, Column):
            return value
        if np.isscalar(value) or value is None or isinstance(value, (np.datetime64,
                                                                      np.timedelta64)):
            return Column.from_scalar(value, len(self), device=self.device)
        return Column.from_numpy(np.asarray(value), device=self.device)

    def __setitem__(self, key, value):
        self._tbl = self._tbl.with_column(str(key), self._as_column(value))

    def __getattr__(self, name):
        tbl = object.__getattribute__(self, "_tbl")
        if name in tbl:
            return Series(column=tbl[name], name=name)
        raise AttributeError(name)

    def assign(self, **kwargs):
        out = self
        for k, v in kwargs.items():
            if callable(v):
                v = v(out)
            out = out._like(out._tbl.with_column(k, out._as_column(v)), self._index)
        return out

    def drop(self, columns=None, **kw):
        cols = columns if isinstance(columns, (list, tuple)) else [columns]
        return self._like(self._tbl.drop(cols), self._index)

    def rename(self, columns: Dict[str, str] = None, **kw):
        return self._like(self._tbl.rename(columns or {}), self._index)

    # ------------------------------------------------------------ operations
    def head(self, n=5):
        return self._rows(0, min(n, len(self)))

    def tail(self, n=5):
        off = max(0, len(self) - n)
        return self._rows(off, len(self) - off)

    @staticmethod
    def _nan_keys_to_nulls(tbl: Table, by) -> Table:
        """pandas' na_position treats NaN keys as missing, not IEEE values."""
        if not any(tbl[k].dtype.is_floating for k in by):
            return tbl
        return Table({n: (unaryop.nans_to_nulls(c) if n in set(by) and c.dtype.is_floating
                          else c) for n, c in tbl})

    def sort_values(self, by, ascending=True, na_position="last", kind=None):
        by = [by] if isinstance(by, str) else list(by)
        asc = ascending if isinstance(ascending, (list, tuple)) else [ascending] * len(by)
        tbl = self._nan_keys_to_nulls(self._embed_index(force=True), by)
        return self._unembed_index(sorting.sort_by_key(tbl, by, [not a for a in asc],
                                                       na_position == "last"))

    def _top(self, n, columns, largest):
        cols = [columns] if isinstance(columns, str) else list(columns)
        tbl = self._nan_keys_to_nulls(self._embed_index(force=True), cols)
        return self._unembed_index(sorting.top_k(tbl, n, cols, largest=largest))

    def nlargest(self, n, columns):
        return self._top(n, columns, True)

    def nsmallest(self, n, columns):
        return self._top(n, columns, False)

    def dropna(self, subset=None, how="any", thresh=None):
        """Drop rows with missing values among ``subset`` (default: every
        column); a NaN is missing (pandas). Where every row left is complete
        among ``subset``, its float columns come out without a mask."""
        names = list(subset) if subset is not None else self._tbl.names
        tbl = self._embed_index(force=True)
        conv = Table({n: (unaryop.nans_to_nulls(c) if n in names and c.dtype.is_floating
                          else c) for n, c in tbl})
        if thresh is not None:
            kt = thresh
        elif how == "all":
            kt = 1
        else:
            kt = len(names)
        out = sc.drop_nulls(conv, names, kt)
        if kt == len(names):
            # no row left has a null or NaN among ``names``: their float
            # columns drop the mask the NaN conversion gave them
            out = Table({n: (_unmasked(c) if n in names and c.dtype.is_floating else c)
                         for n, c in out})
        return self._unembed_index(out)

    def fillna(self, value):
        cols = {}
        for n, c in self._tbl:
            v = value.get(n) if isinstance(value, dict) else value
            if v is None:
                cols[n] = c
            else:
                cc = unaryop.nans_to_nulls(c) if c.dtype.is_floating else c
                cols[n] = unaryop.replace_nulls(cc, v)
        return self._like(Table(cols), self._index)

    def isna(self):
        return self._like(Table({n: Series(column=c, name=n).isna()._col
                                 for n, c in self._tbl}), self._index)

    def isnull(self):
        return self.isna()

    def notna(self):
        return self._map_columns(lambda s: s.notna())

    notnull = notna

    def drop_duplicates(self, subset=None, keep="first"):
        names = list(subset) if subset is not None else self._tbl.names
        return self._unembed_index(sc.distinct(self._embed_index(force=True), names, keep))

    def duplicated(self, subset=None, keep="first"):
        names = ([subset] if isinstance(subset, str) else list(subset)
                 if subset is not None else list(self._tbl.names))
        m = sc.distinct_mask(self._tbl, names, keep)
        return Series(column=Column(dtypes.bool_, ~m.data, None, m.length), name=None)

    def query(self, expr_str: str):
        from ..expr import expressions as E

        env = {n: E.col(n) for n in self._tbl.names}
        mask_expr = eval(expr_str, {"__builtins__": {}}, env)  # noqa: S307
        mask = E.evaluate(mask_expr, self._tbl)
        return self._unembed_index(sc.apply_boolean_mask(self._embed_index(force=True),
                                                         mask))

    def eval(self, expr_str):
        """Column arithmetic ("a + b * 2") through the expression layer."""
        from ..expr import expressions as E

        env = {n: E.col(n) for n in self._tbl.names}
        e = eval(expr_str, {"__builtins__": {}}, env)  # noqa: S307
        return Series(column=E.evaluate(e, self._tbl), name=None)

    def merge(self, right, on=None, left_on=None, right_on=None, how="inner",
              suffixes=("_x", "_y")):
        """pandas merge through ``ops/join.py`` (the hash-table lane with
        the probe kernel where the build side is distinct); the result
        takes a fresh RangeIndex."""
        if on is not None:
            left_on = right_on = [on] if isinstance(on, str) else list(on)
        else:
            left_on = [left_on] if isinstance(left_on, str) else list(left_on)
            right_on = [right_on] if isinstance(right_on, str) else list(right_on)
        how_map = {"inner": "inner", "left": "left", "right": "right", "outer": "full",
                   "leftsemi": "semi", "leftanti": "anti", "cross": "cross"}
        h = how_map[how]
        r = right._tbl if isinstance(right, DataFrame) else right
        if h == "cross":
            return self._like(join_ops.cross_join(self._tbl, r))
        return self._like(join_ops.join(self._tbl, r, left_on, right_on, h,
                                        suffixes=suffixes))

    def join(self, other, on=None, how="left", lsuffix="", rsuffix=""):
        """Index join through the merge engine: each index level becomes a
        key column, ``ops/join.py`` does the work, and the left index is
        restored (python/cudf DataFrame.join -> merge on the index). Two
        MultiIndexes join on all their levels, which must carry the same
        names (pandas); a MultiIndex against a flat index raises. An outer
        join comes out sorted by the index, as in pandas."""
        from .index import MultiIndex, RangeIndex

        sfx = (lsuffix or "_x", rsuffix or "_y")
        if on is not None:
            return self.merge(other, left_on=on, right_on=on, how=how, suffixes=sfx)

        def level(ix):
            return ix.materialize().column if isinstance(ix, RangeIndex) else ix.column

        lix, rix = self.index, other.index
        lmulti, rmulti = isinstance(lix, MultiIndex), isinstance(rix, MultiIndex)
        if lmulti or rmulti:
            if not (lmulti and rmulti and list(lix.names) == list(rix.names)
                    and None not in lix.names):
                raise NotImplementedError("join of a MultiIndex with an index that "
                                          "does not have the same named levels")
            lcols, rcols, names = lix.levels, rix.levels, list(lix.names)
        else:
            lcols, rcols = [level(lix)], [level(rix)]
            names = [lix.name]
        keys = [f"{self._IDX_PREF}{i}" for i in range(len(lcols))]
        lf = self._like(Table({**dict(zip(keys, lcols)), **dict(self._tbl)}))
        rf = other._like(Table({**dict(zip(keys, rcols)), **dict(other._tbl)}))
        out = lf.merge(rf, on=keys, how=how, suffixes=sfx).set_index(
            keys if len(keys) > 1 else keys[0])
        if len(keys) > 1:
            out._index.names = names
        else:
            out._index.name = names[0]
        return out.sort_index() if how == "outer" else out  # pandas sorts an outer join

    def groupby(self, by, sort=True, as_index=True, dropna=True):
        from .groupby import DataFrameGroupBy

        keys = [by] if isinstance(by, str) else list(by)
        return DataFrameGroupBy(self, keys, sort=sort, dropna=dropna, as_index=as_index)

    def concat_with(self, others):
        return self._like(copying.concatenate_tables([self._tbl] + [o._tbl for o in others]))

    def reset_index(self, drop=False):
        from .index import MultiIndex, RangeIndex

        if self._index is None:
            return self
        if drop:
            return self._like(self._tbl)
        if isinstance(self._index, RangeIndex):
            idx = self._index.materialize()
            levels, names = [idx.column], [idx.name]
        elif isinstance(self._index, MultiIndex):
            levels, names = self._index.levels, self._index.names
        else:
            levels, names = [self._index.column], [self._index.name]
        cols = {}
        for i, (c, nm) in enumerate(zip(levels, names)):
            cols[nm if nm is not None else ("index" if len(levels) == 1 else f"level_{i}")] = c
        cols.update(dict(self._tbl))
        return self._like(Table(cols))

    def copy(self, deep=False):
        return self._like(self._tbl, self._index)

    def astype(self, mapping):
        if not isinstance(mapping, dict):
            mapping = {n: mapping for n in self._tbl.names}
        return self._like(Table({
            n: (Series(column=c, name=n).astype(mapping[n])._col if n in mapping else c)
            for n, c in self._tbl}), self._index)

    def select_dtypes(self, include=None):
        kinds = {np.dtype(i).kind for i in (include if isinstance(include, list)
                                            else [include])}
        return self._like(self._tbl.select(
            [n for n, c in self._tbl if dtypes.to_numpy(c.dtype).kind in kinds]))

    def hash_values(self, method="murmur3", seed=0):
        """Per-row murmur3 hash, uint32, equal to the reference's
        (cudf.DataFrame.hash_values). The other methods (xxhash, md5, sha)
        wait for ops/crypto_hash.py."""
        from ..ops import hashing

        if method != "murmur3":
            raise NotImplementedError(f"hash_values(method={method!r}) waits for "
                                      f"ops/crypto_hash.py ({_ITEM4})")
        return Series(column=hashing.hash_values(self._tbl.columns, seed), name=None)

    # ------------------------------------------------------------ reductions
    def _agg_all(self, method):
        from ..utils.real_pandas import pd

        return pd.Series({n: getattr(Series(column=c, name=n), method)()
                          for n, c in self._tbl if c.dtype.is_numeric})

    def sum(self):
        return self._agg_all("sum")

    def mean(self):
        return self._agg_all("mean")

    def min(self):
        return self._agg_all("min")

    def max(self):
        return self._agg_all("max")

    def std(self, ddof=1, numeric_only=True):
        return self._agg_all("std")

    def var(self, ddof=1, numeric_only=True):
        return self._agg_all("var")

    def median(self, numeric_only=True):
        return self._agg_all("median")

    def prod(self, numeric_only=True):
        return self._agg_all("prod")

    def skew(self, numeric_only=True):
        return self._agg_all("skew")

    def _per_column(self, fn, numeric=False):
        from ..utils.real_pandas import pd

        return pd.Series({n: fn(Series(column=c, name=n)) for n, c in self._tbl
                          if not numeric or c.dtype.is_numeric})

    def count(self):
        return self._per_column(lambda s: s.count())

    def any(self):
        return self._per_column(lambda s: bool(s.any()))

    def all(self):
        return self._per_column(lambda s: bool(s.all()))

    def nunique(self):
        return self._per_column(lambda s: s.nunique())

    def quantile(self, q=0.5, numeric_only=True):
        return self._per_column(lambda s: s.quantile(q), numeric=True)

    def mode(self):
        """Per-column modes through the groupby engine (count per value,
        keep the largest counts); only the short mode lists are assembled
        on the host."""
        from ..ops.groupby import AggSpec, groupby_aggregate
        from ..utils.real_pandas import pd

        mode_lists = {}
        for n, c in self._tbl:
            got = groupby_aggregate(Table({n: c}), [n],
                                    [AggSpec(n, "size", "__cnt")]).to_pandas()
            mode_lists[n] = ([] if len(got) == 0 else
                             list(got.loc[got["__cnt"] == got["__cnt"].max(), n]))
        width = max((len(v) for v in mode_lists.values()), default=0)
        out = {n: list(v) + [np.nan] * (width - len(v)) for n, v in mode_lists.items()}
        return DataFrame.from_pandas(pd.DataFrame(out), device=self.device)

    def agg(self, arg):
        """agg("sum"), agg(["sum", "mean"]) or agg({"col": "sum"})."""
        from ..utils.real_pandas import pd

        if isinstance(arg, str):
            return getattr(self, arg)()
        if isinstance(arg, (list, tuple)):
            return pd.DataFrame({k: getattr(self, k)() for k in arg}).T
        return pd.Series({n: getattr(Series(column=self._tbl[n], name=n), how)()
                          for n, how in arg.items()})

    aggregate = agg

    def describe(self):
        from ..utils.real_pandas import pd

        num = [(n, Series(column=c, name=n)) for n, c in self._tbl if c.dtype.is_numeric]
        rows = {stat: {n: getattr(s, stat)() for n, s in num}
                for stat in ("count", "mean", "std", "min", "max")}
        for q, name in ((0.25, "25%"), (0.5, "50%"), (0.75, "75%")):
            rows[name] = {n: s.quantile(q) for n, s in num}
        order = ["count", "mean", "std", "min", "25%", "50%", "75%", "max"]
        return pd.DataFrame({n: [rows[s][n] for s in order] for n, _ in num}, index=order)

    def corr(self):
        """Pearson correlation over pairwise complete observations (pandas:
        rows with a NaN or null drop per column pair), by ``Series.corr``."""
        from ..utils.real_pandas import pd

        num = [Series(column=c, name=n) for n, c in self._tbl
               if c.dtype.is_numeric and c.dtype.kind != dtypes.Kind.BOOL]
        names = [s.name for s in num]
        return pd.DataFrame([[a.corr(b) for b in num] for a in num], index=names,
                            columns=names)

    # ------------------------------------------------- column-wise transforms
    def _map_columns(self, fn, numeric_only=False):
        """Apply a Series -> Series transform to each column."""
        return self._like(Table({
            n: (c if numeric_only and not c.dtype.is_numeric
                else fn(Series(column=c, name=n))._col) for n, c in self._tbl}),
            self._index)

    def _binop_frame(self, other, op, reflect=False):
        return self._like(Table({
            n: Series(column=c, name=n)._binop(other[n] if isinstance(other, DataFrame)
                                               else other, op, reflect)._col
            for n, c in self._tbl}), self._index)

    def add(self, o):
        return self._binop_frame(o, "add")

    def radd(self, o):
        return self._binop_frame(o, "add", True)

    def sub(self, o):
        return self._binop_frame(o, "sub")

    def rsub(self, o):
        return self._binop_frame(o, "sub", True)

    def mul(self, o):
        return self._binop_frame(o, "mul")

    def rmul(self, o):
        return self._binop_frame(o, "mul", True)

    def div(self, o):
        return self._binop_frame(o, "div")

    truediv = div

    def rdiv(self, o):
        return self._binop_frame(o, "div", True)

    rtruediv = rdiv

    def floordiv(self, o):
        return self._binop_frame(o, "floordiv")

    def rfloordiv(self, o):
        return self._binop_frame(o, "floordiv", True)

    def mod(self, o):
        return self._binop_frame(o, "mod")

    def rmod(self, o):
        return self._binop_frame(o, "mod", True)

    def pow(self, o):
        return self._binop_frame(o, "pow")

    def rpow(self, o):
        return self._binop_frame(o, "pow", True)

    def eq(self, o):
        return self._binop_frame(o, "eq")

    def ne(self, o):
        return self._binop_frame(o, "ne")

    def lt(self, o):
        return self._binop_frame(o, "lt")

    def le(self, o):
        return self._binop_frame(o, "le")

    def gt(self, o):
        return self._binop_frame(o, "gt")

    def ge(self, o):
        return self._binop_frame(o, "ge")

    def __add__(self, o):
        return self.add(o)

    def __sub__(self, o):
        return self.sub(o)

    def __mul__(self, o):
        return self.mul(o)

    def __truediv__(self, o):
        return self.div(o)

    def abs(self):
        return self._map_columns(lambda s: s.abs(), numeric_only=True)

    def round(self, decimals=0):
        return self._map_columns(lambda s: s.round(decimals), numeric_only=True)

    def clip(self, lower=None, upper=None):
        return self._map_columns(lambda s: s.clip(lower, upper), numeric_only=True)

    def cumsum(self):
        return self._map_columns(lambda s: s.cumsum(), numeric_only=True)

    def cummax(self):
        return self._map_columns(lambda s: s.cummax(), numeric_only=True)

    def cummin(self):
        return self._map_columns(lambda s: s.cummin(), numeric_only=True)

    def cumprod(self):
        return self._map_columns(lambda s: s.cumprod(), numeric_only=True)

    def shift(self, periods=1):
        return self._map_columns(lambda s: s.shift(periods))

    def diff(self, periods=1):
        return self._map_columns(lambda s: s.diff(periods), numeric_only=True)

    def pct_change(self, periods=1):
        return self._map_columns(lambda s: s.pct_change(periods), numeric_only=True)

    def ffill(self):
        return self._map_columns(lambda s: s.ffill())

    def bfill(self):
        return self._map_columns(lambda s: s.bfill())

    def rank(self, method="average", ascending=True, pct=False):
        return self._map_columns(lambda s: s.rank(method, ascending, pct),
                                 numeric_only=True)

    def where(self, cond, other=np.nan):
        return self._like(Table({
            n: Series(column=c, name=n).where(cond[n] if isinstance(cond, DataFrame)
                                              else cond, other)._col
            for n, c in self._tbl}), self._index)

    def mask(self, cond, other=np.nan):
        inv = (~cond if isinstance(cond, Series)
               else cond._map_columns(lambda s: ~s) if isinstance(cond, DataFrame)
               else ~np.asarray(cond))
        return self.where(inv, other)

    def isin(self, values):
        return self._map_columns(lambda s: s.isin(values))

    def replace(self, to_replace, value=None):
        """Replace values column by column; a column whose dtype cannot hold
        the keys is left as it is (as in the reference)."""
        if isinstance(to_replace, dict) and value is None:
            keys, vals = list(to_replace.keys()), list(to_replace.values())
        else:
            keys = list(np.asarray([to_replace]).ravel())
            vals = list(np.asarray([value]).ravel())
            if len(vals) == 1 and len(keys) > 1:
                vals = vals * len(keys)
        cols = {}
        for n, c in self._tbl:
            try:
                cols[n] = unaryop.find_and_replace(c, keys, vals)
            except (TypeError, ValueError):
                cols[n] = c
        return self._like(Table(cols), self._index)

    def reindex(self, columns=None):
        if columns is None:
            return self
        have = set(self._tbl.names)
        return self._like(Table({
            n: (self._tbl[n] if n in have
                else Column.from_scalar(None, len(self), dtypes.float64, self.device))
            for n in columns}), self._index)

    def filter(self, items=None, like=None, regex=None):
        import re as _re

        names = list(self._tbl.names)
        if items is not None:
            keep = [n for n in names if n in set(items)]
        elif like is not None:
            keep = [n for n in names if like in str(n)]
        else:
            pat = _re.compile(regex)
            keep = [n for n in names if pat.search(str(n))]
        return self[keep]

    def take(self, indices):
        """Rows by position, with their labels (pandas)."""
        n = len(indices)
        return self._unembed_index(copying.gather_table(
            self._embed_index(force=True), take_indices(indices, n, self.device), n))

    def sample(self, n=None, frac=None, random_state=None):
        rng = np.random.default_rng(random_state)
        k = n if n is not None else max(1, int(len(self) * (frac or 1.0)))
        return self.take(np.sort(rng.choice(len(self), size=min(k, len(self)),
                                            replace=False)))

    def pop(self, name):
        s = self[name]
        self._tbl = self._tbl.drop([name])
        return s

    def insert(self, loc, name, value):
        col = self._as_column(value)
        names = list(self._tbl.names)
        names.insert(loc, name)
        self._tbl = Table({n: (col if n == name else self._tbl[n]) for n in names})

    def items(self):
        return iter((n, Series(column=c, name=n)) for n, c in self._tbl)

    def iterrows(self):
        return self.to_pandas().iterrows()

    def itertuples(self, index=True, name="Pandas"):
        return self.to_pandas().itertuples(index=index, name=name)

    def apply(self, func, axis=0):
        from ..utils.real_pandas import pd

        if axis in (0, "index"):
            return pd.Series({n: func(Series(column=c, name=n)) for n, c in self._tbl})
        return self.to_pandas().apply(func, axis=1)  # row-wise: on the host

    def pipe(self, func, *a, **kw):
        return func(self, *a, **kw)

    @property
    def size(self):
        return len(self) * len(self.columns)

    @property
    def empty(self):
        return len(self) == 0

    def squeeze(self, axis=None):
        names = list(self._tbl.names)
        return self[names[0]] if len(names) == 1 else self

    @property
    def T(self):
        return self.transpose()

    def transpose(self):
        from ..ops.filling import transpose as _t

        return self._like(_t(self._tbl))

    def melt(self, id_vars=None, value_vars=None, var_name="variable",
             value_name="value"):
        """Wide to long (cudf::melt, cpp/src/reshape): one piece per value
        column, concatenated on the device."""
        id_vars = [id_vars] if isinstance(id_vars, str) else list(id_vars or [])
        value_vars = ([value_vars] if isinstance(value_vars, str)
                      else list(value_vars or [n for n in self._tbl.names
                                               if n not in set(id_vars)]))
        pieces = []
        for v in value_vars:
            cols = {n: self._tbl[n] for n in id_vars}
            cols[var_name] = Column.from_scalar(str(v), len(self), device=self.device)
            cols[value_name] = self._tbl[v]
            pieces.append(Table(cols))
        return self._like(copying.concatenate_tables(pieces))

    def pivot_table(self, values=None, index=None, columns=None, aggfunc="mean"):
        """Device groupby, then the (small) aggregated result laid out wide
        on the host (python/cudf pivot_table -> groupby + scatter)."""
        from ..utils.real_pandas import pd

        idx = [index] if isinstance(index, str) else list(index)
        cols = [columns] if isinstance(columns, str) else list(columns)
        got = (self.groupby(idx + cols, as_index=False)
               .agg(**{"__v": (values, aggfunc)})).to_pandas()
        ikeys = (got[idx[0]].to_numpy() if len(idx) == 1
                 else np.asarray(list(zip(*[got[k] for k in idx])), object))
        ckeys = (got[cols[0]].to_numpy() if len(cols) == 1
                 else np.asarray(list(zip(*[got[k] for k in cols])), object))
        iu, irank = np.unique(ikeys, return_inverse=True)
        cu, crank = np.unique(ckeys, return_inverse=True)
        mat = np.full((len(iu), len(cu)), np.nan)
        mat[irank, crank] = got["__v"].to_numpy()
        out = pd.DataFrame({c: mat[:, j] for j, c in enumerate(cu)})
        out.index = pd.Index(iu, name=idx[0] if len(idx) == 1 else None)
        return out

    def value_counts(self, subset=None, ascending=False):
        from .index import Index, MultiIndex

        names = ([subset] if isinstance(subset, str) else list(subset)
                 if subset is not None else list(self._tbl.names))
        g = self.groupby(names, as_index=False).agg(count=(names[0], "size"))
        t = g.sort_values("count", ascending=ascending)._tbl
        levels = [t[n] for n in names]
        idx = Index(levels[0], names[0]) if len(names) == 1 else MultiIndex(levels, names)
        return Series(column=t["count"], name="count", index=idx)

    def explode(self, column):
        raise NotImplementedError(f"explode reads a list column, which waits for "
                                  f"core/lists.py ({_ITEM4})")

    # --------------------------------------------------------------- export
    def to_dict(self, orient="dict"):
        return self.to_pandas().to_dict(orient)

    def to_records(self, index=False):
        return self.to_pandas().to_records(index=index)

    def to_numpy(self):
        return self.to_pandas().to_numpy()

    def to_json(self, path_or_buf=None, **kw):
        return self.to_pandas().to_json(path_or_buf, **kw)

    def memory_usage(self, deep=False):
        from ..utils.real_pandas import pd

        return pd.Series({n: c.capacity * c.data.element_size() for n, c in self._tbl})

    def info(self, buf=None):
        import sys as _sys

        out = buf or _sys.stdout
        out.write(f"cudf_tpu_torch.DataFrame: {len(self)} rows x "
                  f"{len(self.columns)} columns\n")
        for n, c in self._tbl._columns.items():
            out.write(f"  {n}: {_np_dtype(c)}\n")

    def to_pandas(self):
        pdf = self._tbl.to_pandas()
        if self._index is not None:
            pdf.index = self._index.to_pandas()
        return pdf

    def to_arrow(self):
        return self._tbl.to_arrow()

    def to_parquet(self, path, **kw):
        from .. import io

        io.write_parquet(self._tbl, path, **kw)

    def to_csv(self, path, **kw):
        from .. import io

        io.write_csv(self._tbl, path)

    @classmethod
    def from_pandas(cls, df, device=None):
        from . import index as index_mod

        dev = resolve_device(device)
        idx = index_mod.from_pandas(df.index, dev)
        if idx is not None:
            df = df.reset_index(drop=True)
        return cls._from_table(Table.from_pandas(df, dev), idx, dev)

    @classmethod
    def from_arrow(cls, at, device=None):
        dev = resolve_device(device)
        return cls._from_table(Table.from_arrow(at, dev), None, dev)


def _sliced_index(index, offset: int, n: int, device):
    """The labels of rows [offset, offset + n); None for the default index
    of a frame that starts at row 0."""
    from .index import RangeIndex

    if index is None:
        return RangeIndex(offset + n, offset, device=device) if offset else None
    return index.slice(offset, n)


def _np_dtype(c) -> np.dtype:
    """A column's numpy dtype; a deferred column's from its source's arrow
    type (no decode)."""
    if isinstance(c, Deferred):
        return c.np_dtype
    return dtypes.to_numpy(c.dtype)


class _ILoc:
    def __init__(self, df):
        self._df = df

    def __getitem__(self, key):
        df = self._df
        if isinstance(key, tuple):
            rows, cols = key
            sub = df
            if isinstance(cols, list):
                sub = sub[[sub._tbl.names[c] if isinstance(c, int) else c for c in cols]]
            return sub.iloc[rows]
        if isinstance(key, slice):
            start, stop, step = key.indices(len(df))
            if step != 1:
                raise NotImplementedError("a slice with a step")
            return df[start:stop]
        if isinstance(key, int):
            return df._tbl.slice(key, 1).to_pandas().iloc[0]
        return df.take(key)


class _Loc:
    """Label-based row selection: a bool mask, a list of labels, a label."""

    def __init__(self, df):
        self._df = df

    def __getitem__(self, key):
        from .index import Index, MultiIndex, RangeIndex

        df = self._df
        if isinstance(key, tuple):
            # (rows, cols), or a MultiIndex label tuple: label tuples have
            # at most n_levels entries, none of which names a column
            if isinstance(df.index, MultiIndex) and len(key) <= len(df.index.levels) \
                    and not any(isinstance(k, (list, slice)) or k in df._tbl.names
                                for k in key if isinstance(k, (str, int))):
                return self._multiindex_select(key)
            rows, cols = key
            sub = df.loc[rows]
            return sub[cols]
        if isinstance(key, Series):
            return df[key]
        idx = df.index
        if isinstance(idx, RangeIndex):
            icol = idx.materialize().column
        elif isinstance(idx, Index):
            icol = idx.column
        else:
            return self._multiindex_select(key if isinstance(key, tuple) else (key,))
        iser = Series(column=icol)
        if isinstance(key, (list, np.ndarray)):
            return df[iser.isin(list(key))]
        return df[iser == key]

    def _multiindex_select(self, labels: tuple):
        """MultiIndex partial indexing: labels match the levels in order."""
        from ..ops.binaryop import binary_op

        df = self._df
        mask = None
        for lvl, lab in zip(df.index.levels, labels):
            m = (Series(column=lvl) == lab)._col
            mask = m if mask is None else binary_op(mask, m, "and")
        return df[Series(column=mask)]


def concat(objs: Sequence[Union[DataFrame, Series]], ignore_index=True, axis=0):
    if axis == 1:
        cols = {}
        for o in objs:
            if isinstance(o, Series):
                cols[o.name or f"col{len(cols)}"] = o._col
            else:
                cols.update(dict(o._tbl))
        return objs[0]._like(Table(cols)) if isinstance(objs[0], DataFrame) \
            else DataFrame._from_table(Table(cols))
    if isinstance(objs[0], Series):
        return Series(column=copying.concatenate([o._col for o in objs]), name=objs[0].name)
    return objs[0]._like(copying.concatenate_tables([o._tbl for o in objs]))
