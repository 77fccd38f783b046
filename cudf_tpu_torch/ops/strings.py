"""String dictionary unification (counterpart of the first part of
``cudf_tpu/ops/strings.py``).

String columns hold int32 codes into a host-side sorted dictionary, so
comparisons and joins on strings are integer problems once both sides
share one dictionary. The rest of the reference module (value-level string
kernels) is a later slice.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.column import Column


def _remap_codes(col: Column, remap: np.ndarray, new_dict: np.ndarray) -> Column:
    """Gather codes through a host-computed remap table (device gather)."""
    data = col.data
    if len(remap):
        table = torch.as_tensor(remap.astype(np.int32), device=col.device)
        data = table[data.to(torch.int64).clamp(0, len(remap) - 1)]
    return Column(col.dtype, data, col.validity, col.length, new_dict)


def unify_dictionaries(cols: List[Column]) -> List[Column]:
    """Recode string columns onto the union dictionary (sorted)."""
    dicts = [c.dictionary if c.dictionary is not None else np.array([], dtype=str)
             for c in cols]
    if all(d is dicts[0] or (len(d) == len(dicts[0]) and (d == dicts[0]).all())
           for d in dicts[1:]):
        return list(cols)
    merged = np.unique(np.concatenate([d.astype(str) for d in dicts]))
    return [_remap_codes(c, np.searchsorted(merged, d.astype(str)), merged)
            for c, d in zip(cols, dicts)]

