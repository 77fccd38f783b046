"""Dictionary column ops: encode, decode, set_keys (counterpart of
``cudf_tpu/ops/dictionary.py``).

Analog of cpp/src/dictionary/. Strings are already dictionary-encoded;
these functions expose the encoding for any column (the categorical
support) and manage key domains. The keys are host metadata: they are
small by construction.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from .strings import _host_table, _table_gather


def encode(col: Column) -> Tuple[Column, np.ndarray]:
    """Column -> (int32 codes column, sorted distinct host keys)
    (cudf::dictionary::encode): distinct and a search on the device."""
    if col.dtype.is_string:
        return Column(dtypes.int32, col.data, col.validity, col.length), col.dictionary
    from .search import _searchsorted
    from .sorting import sort_column
    from .stream_compaction import distinct

    uniq = sort_column(distinct(Table({"v": col}))["v"])
    codes = _searchsorted(uniq, col, "left").to(torch.int32)
    return Column(dtypes.int32, codes, col.validity, col.length), uniq.to_numpy()


def decode(codes: Column, keys: np.ndarray) -> Column:
    """codes + keys -> the materialized column (cudf::dictionary::decode)."""
    keys = np.asarray(keys)
    if keys.dtype == object or keys.dtype.kind in ("U", "S"):
        return Column(dtypes.string, codes.data, codes.validity, codes.length,
                      keys.astype(str))
    data = _table_gather(_host_table(keys, codes), codes.data.to(torch.int64))
    return Column(dtypes.from_numpy(keys.dtype), data, codes.validity, codes.length)


def set_keys(col: Column, new_keys: np.ndarray) -> Column:
    """Remap a string column onto a given key domain (sorted here); values
    outside it become null (cudf::dictionary::set_keys)."""
    if not col.dtype.is_string:
        raise TypeError(f"set_keys needs a string column, got {col.dtype}")
    d = (col.dictionary if col.dictionary is not None else np.array([], str)).astype(str)
    nk = np.sort(np.asarray(new_keys).astype(str), kind="stable")
    pos = np.searchsorted(nk, d)
    pos_c = np.clip(pos, 0, max(len(nk) - 1, 0))
    found = (pos < len(nk)) & (nk[pos_c] == d) if len(nk) else np.zeros(len(d), bool)
    remap = np.where(found, pos, -1).astype(np.int32)
    codes = _table_gather(_host_table(remap, col), col.data) if len(d) else col.data
    valid = codes >= 0
    v = valid if col.validity is None else (col.validity & valid)
    return Column(dtypes.string, codes.clamp(min=0), v, col.length, nk)
