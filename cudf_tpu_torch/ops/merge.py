"""K-way merge of pre-sorted tables (counterpart of ``cudf_tpu/ops/merge.py``;
libcudf's cpp/src/merge/): concatenate, then one stable sort by the merge
keys, which keeps each input's rows in their order among equal keys."""
from __future__ import annotations

from typing import Sequence

from ..core.table import Table
from .copying import concatenate_tables
from .sorting import sort_by_key


def merge_sorted(tables: Sequence[Table], keys: Sequence[str],
                 descending=False, nulls_last=True) -> Table:
    """Merge tables that are each sorted by `keys` into one sorted table."""
    merged = concatenate_tables(list(tables))
    desc = [descending] * len(keys) if isinstance(descending, bool) else list(descending)
    nl = [nulls_last] * len(keys) if isinstance(nulls_last, bool) else list(nulls_last)
    return sort_by_key(merged, list(keys), desc, nl)
