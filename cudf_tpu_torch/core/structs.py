"""Struct columns: named child columns sharing one row geometry
(counterpart of ``cudf_tpu/core/structs.py``).

Analog of cpp/src/structs/. A StructColumn bundles child Columns and an
outer validity; field access is zero-copy, and struct rows take part in
sort, group and join keys by flattening their children into the key list
(``key_columns``), as the reference's row operators flatten nested types.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .column import Column, _pad_to, resolve_device
from ..utils.padding import bucket_capacity


class StructColumn:
    __slots__ = ("children", "length", "validity")

    def __init__(self, children: Dict[str, Column], length: int,
                 validity: Optional[torch.Tensor] = None):
        self.children = dict(children)
        self.length = int(length)
        self.validity = validity

    @classmethod
    def from_pydict_rows(cls, rows: Sequence[Optional[dict]], device=None) -> "StructColumn":
        """From host rows of dicts; ``None`` is a null struct, a missing or
        ``None`` field a null field. The fields are the first row's keys."""
        dev = resolve_device(device)
        n = len(rows)
        keys: List[str] = next((list(r.keys()) for r in rows if r is not None), [])
        children = {}
        for k in keys:
            vals = [None if r is None else r.get(k) for r in rows]
            present = np.array([v is not None for v in vals])
            arr = np.asarray([0 if v is None else v for v in vals])
            children[k] = Column.from_numpy(arr, None if present.all() else present,
                                            device=dev)
        valid = np.array([r is not None for r in rows], bool)
        v = None if valid.all() else _pad_to(valid, bucket_capacity(n), dev, False)
        return cls(children, n, v)

    def field(self, name: str) -> Column:
        """struct.field: the outer nulls propagate into the field."""
        c = self.children[name]
        if self.validity is None:
            return c
        v = self.validity if c.validity is None else c.validity & self.validity
        return Column(c.dtype, c.data, v, c.length, c.dictionary)

    def to_pylist(self) -> List[Optional[dict]]:
        vals = {k: self.field(k).to_numpy() for k in self.children}
        ov = None if self.validity is None else self.validity[: self.length].cpu().numpy()
        return [None if ov is not None and not ov[i] else {k: vals[k][i] for k in self.children}
                for i in range(self.length)]

    def key_columns(self) -> List[Column]:
        """The flattened children for sort, group and join keys."""
        return [self.field(k) for k in self.children]
