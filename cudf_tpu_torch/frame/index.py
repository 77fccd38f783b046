"""Index, RangeIndex and MultiIndex for the frame layer (counterpart of
``cudf_tpu/frame/index.py``).

Analog of cudf's Index hierarchy (python/cudf/cudf/core/index.py,
multiindex.py). The default RangeIndex is virtual: metadata only, no
device buffer, as cudf.RangeIndex. A materialized Index is one Column, a
MultiIndex a Column per level. Row-permuting frame ops gather the index
columns with the permutation they apply to the data.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.column import Column
from ..ops import copying


class RangeIndex:
    """Virtual ``start, start + step, ... < stop`` positional index, built
    on ``device`` only when something needs its values."""

    __slots__ = ("start", "stop", "step", "name", "device")

    def __init__(self, stop: int, start: int = 0, step: int = 1, name=None,
                 device=None):
        self.start, self.stop, self.step = start, stop, step
        self.name = name
        self.device = device

    def __len__(self):
        return max(0, (self.stop - self.start + self.step - 1) // self.step)

    @property
    def is_default(self) -> bool:
        return self.start == 0 and self.step == 1 and self.name is None

    def materialize(self) -> "Index":
        from ..ops.filling import sequence

        return Index(sequence(len(self), self.start, self.step, device=self.device),
                     self.name)

    def take(self, perm, n: int) -> "Index":
        return self.materialize().take(perm, n)

    def slice(self, offset: int, length: int) -> "RangeIndex":
        s = self.start + offset * self.step
        return RangeIndex(s + length * self.step, s, self.step, self.name, self.device)

    def to_pandas(self):
        from ..utils.real_pandas import pd

        return pd.RangeIndex(self.start, self.stop, self.step, name=self.name)

    def columns(self) -> List[Column]:
        return [self.materialize().column]


class Index:
    """Materialized single-level index: one Column and a name."""

    __slots__ = ("column", "name")

    def __init__(self, column: Column, name=None):
        self.column = column
        self.name = name

    def __len__(self):
        return self.column.length

    def take(self, perm, n: int) -> "Index":
        return Index(copying.gather(self.column, perm, n), self.name)

    def slice(self, offset: int, length: int) -> "Index":
        return Index(self.column.slice(offset, length), self.name)

    def to_pandas(self):
        from ..utils.real_pandas import pd

        return pd.Index(self.column.to_numpy(), name=self.name)

    def columns(self) -> List[Column]:
        return [self.column]


class MultiIndex:
    """Multi-level index: a Column per level."""

    __slots__ = ("levels", "names")

    def __init__(self, levels: Sequence[Column], names: Optional[Sequence] = None):
        self.levels = list(levels)
        self.names = list(names) if names is not None else [None] * len(self.levels)

    def __len__(self):
        return self.levels[0].length if self.levels else 0

    def take(self, perm, n: int) -> "MultiIndex":
        return MultiIndex([copying.gather(c, perm, n) for c in self.levels], self.names)

    def slice(self, offset: int, length: int) -> "MultiIndex":
        return MultiIndex([c.slice(offset, length) for c in self.levels], self.names)

    def to_pandas(self):
        from ..utils.real_pandas import pd

        return pd.MultiIndex.from_arrays([c.to_numpy() for c in self.levels],
                                         names=self.names)

    def columns(self) -> List[Column]:
        return list(self.levels)


def from_pandas(pidx, device=None) -> Optional[object]:
    """Capture a pandas index on ``device``; None for the default
    RangeIndex, which costs nothing."""
    from ..utils.real_pandas import pd

    if isinstance(pidx, pd.RangeIndex):
        if pidx.start == 0 and pidx.step == 1 and pidx.name is None:
            return None
        return RangeIndex(pidx.stop, pidx.start, pidx.step, pidx.name, device)
    if isinstance(pidx, pd.MultiIndex):
        return MultiIndex([Column.from_numpy(np.asarray(pidx.get_level_values(i)),
                                             device=device)
                           for i in range(pidx.nlevels)], list(pidx.names))
    return Index(Column.from_numpy(np.asarray(pidx), device=device), pidx.name)
