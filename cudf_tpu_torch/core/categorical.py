"""Categorical columns: dictionary codes and an ORDERED host category list
(counterpart of ``cudf_tpu/core/categorical.py``).

Analog of python/cudf/cudf/core/column/categorical.py (CategoricalColumn)
and cpp dictionary columns (cpp/src/dictionary/). The device buffer holds
int32 codes, the category list is host metadata. Unlike a string column's
sorted dictionary, the categories keep their DECLARED order; pandas sorts
and compares categoricals by that order, so code order is still the
semantic order and every sort, groupby and join works on the raw codes.

Missing values are validity-null codes (pandas code -1 maps to null).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes
from .column import Column, _pad_to, _validity_of_marked, resolve_device
from .dtypes import DType, Kind
from ..utils.padding import bucket_capacity


def categorical_dtype(ordered: bool = False) -> DType:
    return DType(Kind.DICTIONARY, 32, ("category", bool(ordered)))


def is_categorical(col: Column) -> bool:
    return col.dtype.kind == Kind.DICTIONARY and \
        isinstance(col.dtype.param, tuple) and col.dtype.param[0] == "category"


def ordered(col: Column) -> bool:
    return bool(col.dtype.param[1]) if is_categorical(col) else False


def from_values(values: np.ndarray, categories: Optional[Sequence] = None,
                ordered: bool = False, device=None) -> Column:
    """Factorize host values into a categorical column (pd.Categorical):
    the categories are the sorted distinct values unless given."""
    vals = np.asarray(values, dtype=object)
    isnull = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                       for v in vals], dtype=bool)
    if categories is None:
        cats = np.array(sorted({v for v, n in zip(vals.tolist(), isnull) if not n}),
                        dtype=object)
    else:
        cats = np.asarray(list(categories), dtype=object)
    index = {v: i for i, v in enumerate(cats.tolist())}
    codes = np.array([index.get(v, -1) if not n else -1
                      for v, n in zip(vals.tolist(), isnull)], np.int32)
    return from_codes(codes, cats, ordered, device)


def from_column(col: Column, ordered: bool = False) -> Column:
    """Factorize a column into a categorical on its device: the categories
    are its sorted distinct values (a string column's codes follow its
    sorted dictionary), and a null or NaN becomes a null code. Only the
    category list is read to the host."""
    n = col.length
    x = col.data[:n]
    valid = col.valid_mask()[:n]
    if col.dtype.is_floating:
        valid = valid & ~torch.isnan(x)
    uniq, inv = torch.unique(x[valid], sorted=True, return_inverse=True)
    cats = Column(col.dtype, uniq, None, uniq.numel(), col.dictionary).to_numpy()
    codes = torch.zeros(col.capacity, dtype=torch.int32, device=col.device)
    codes[:n][valid] = inv.to(torch.int32)
    v = None
    if not bool(valid.all()):
        v = torch.zeros(col.capacity, dtype=torch.bool, device=col.device)
        v[:n] = valid
    return Column(categorical_dtype(ordered), codes, v, n,
                  dictionary=np.asarray(cats.tolist(), dtype=object))


def decode(col: Column) -> Column:
    """The values under a categorical's codes, on its device: one gather
    from a column of the (few) categories."""
    from ..ops.copying import gather
    from ..utils.real_pandas import pd

    cats = Column.from_numpy(pd.Index(list(col.dictionary)).to_numpy(), device=col.device)
    out = gather(cats, col.data, col.length)
    return Column(out.dtype, out.data, col.validity, col.length, out.dictionary)


def from_codes(codes: np.ndarray, categories: np.ndarray,
               ordered: bool = False, device=None) -> Column:
    """A categorical column from pandas-style codes (-1 is null). The codes
    cross to the device at their own integer width (pandas' int8 for up to
    127 categories), unpadded, in one copy; the null test, the widening to
    int32 and the zeroing of nulls run there."""
    dev = resolve_device(device)
    codes = np.asarray(codes)
    n = len(codes)
    cap = bucket_capacity(max(n, 1))
    staged = _pad_to(codes, n, dev)
    data = torch.zeros(cap, dtype=torch.int32, device=dev)
    data[:n].copy_(staged).clamp_(min=0)
    v = _validity_of_marked(staged < 0, cap)
    return Column(categorical_dtype(ordered), data, v, n,
                  dictionary=np.asarray(categories, dtype=object))


def from_pandas_categorical(cat, device=None) -> Column:
    """Build from a pandas.Categorical (codes -1 == null)."""
    return from_codes(cat.codes,
                      np.asarray(cat.categories.to_numpy(), dtype=object),
                      bool(cat.ordered), device)


def to_pandas_categorical(col: Column):
    from ..utils.real_pandas import pd

    n = col.length
    codes = col.data[:n].cpu().numpy().astype(np.int64)
    if col.validity is not None:
        codes = np.where(col.validity[:n].cpu().numpy(), codes, -1)
    return pd.Categorical.from_codes(codes, categories=list(col.dictionary),
                                     ordered=ordered(col))


def _remap(col: Column, new_cats: np.ndarray, new_ordered: bool) -> Column:
    """Re-code onto a new category list: a small host remap table and one
    device gather through it (the set_keys pattern,
    cpp/src/dictionary/set_keys.cu); a category not in the new list
    becomes null."""
    old = list(col.dictionary) if col.dictionary is not None else []
    index = {v: i for i, v in enumerate(np.asarray(new_cats, object).tolist())}
    table = torch.tensor([index.get(v, -1) for v in old] + [-1], dtype=torch.int32,
                         device=col.device)
    new_codes = table[col.data.clamp(0, table.shape[0] - 1).to(torch.int64)]
    valid = new_codes >= 0
    if col.validity is not None:
        valid = valid & col.validity
    return Column(categorical_dtype(new_ordered), torch.where(valid, new_codes, 0),
                  valid, col.length, dictionary=np.asarray(new_cats, dtype=object))


def set_categories(col: Column, new_categories, ordered_: Optional[bool] = None) -> Column:
    return _remap(col, np.asarray(list(new_categories), object),
                  ordered(col) if ordered_ is None else bool(ordered_))


def add_categories(col: Column, new_categories) -> Column:
    have = set(col.dictionary.tolist())
    cats = list(col.dictionary) + [c for c in new_categories if c not in have]
    return _remap(col, np.asarray(cats, object), ordered(col))


def remove_categories(col: Column, removals) -> Column:
    rm = set(removals)
    cats = [c for c in col.dictionary.tolist() if c not in rm]
    return _remap(col, np.asarray(cats, object), ordered(col))


def rename_categories(col: Column, mapping) -> Column:
    if callable(mapping):
        cats = [mapping(c) for c in col.dictionary.tolist()]
    elif isinstance(mapping, dict):
        cats = [mapping.get(c, c) for c in col.dictionary.tolist()]
    else:
        cats = list(mapping)
    return Column(col.dtype, col.data, col.validity, col.length,
                  dictionary=np.asarray(cats, dtype=object))


def reorder_categories(col: Column, new_categories, ordered_: Optional[bool] = None) -> Column:
    if set(new_categories) != set(col.dictionary.tolist()):
        raise ValueError("reorder_categories: the items differ from the categories")
    return _remap(col, np.asarray(list(new_categories), object),
                  ordered(col) if ordered_ is None else bool(ordered_))


def as_ordered(col: Column, value: bool = True) -> Column:
    return Column(categorical_dtype(value), col.data, col.validity, col.length,
                  col.dictionary)


def unify_categoricals(cols: Sequence[Column]) -> list:
    """Re-code categoricals onto the UNION category list (first-seen order,
    left to right) so codes compare across columns: the categorical
    analog of strings.unify_dictionaries, used by join key promotion."""
    seen: dict = {}
    for c in cols:
        for v in (c.dictionary.tolist() if c.dictionary is not None else []):
            if v not in seen:
                seen[v] = len(seen)
    union = np.array(list(seen.keys()), dtype=object)
    ord_ = all(ordered(c) for c in cols)
    return [_remap(c, union, ord_) for c in cols]


def codes_column(col: Column) -> Column:
    """pandas .cat.codes: int32 codes with -1 for nulls (non-null output)."""
    data = col.data.to(torch.int32)
    if col.validity is not None:
        data = torch.where(col.validity, data, -1)
    return Column(dtypes.int32, data, None, col.length)
