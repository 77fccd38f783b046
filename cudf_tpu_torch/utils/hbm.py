"""Device-memory budget: reservation admission with LRU spill
(counterpart of ``cudf_tpu/utils/hbm.py``).

The analog of rapidsmpf's BufferResource: a buffer reserves its bytes
before it moves to the device, and a reservation that does not fit spills
the least recently used resident buffers back to the host until it does.
The budget governs the bytes this package keeps live references to: every
resident out-of-core partition (``parallel/partitioned.py``) registers
here. Temporaries inside an op are the caching allocator's business; the
chunked ops (``ops/chunked.py``) read ``budget`` to size their chunks.

The name keeps the reference's (HBM is the H100's memory too), and so does
the environment bootstrap: ``CUDF_TPU_HBM_BUDGET`` (bytes, a float such as
``2e9``) installs a budget at the first ``get_hbm_budget`` call.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Optional


class HbmBudget:
    """Tracks live device bytes; admission spills LRU victims to fit."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._lock = threading.RLock()
        self._live: "OrderedDict[int, tuple[int, Callable[[], None]]]" = OrderedDict()
        self._used = 0
        self.spill_count = 0
        self.spilled_bytes = 0
        self.admitted = 0

    def admit(self, key: int, nbytes: int, spill_fn: Callable[[], None]) -> None:
        """Reserve ``nbytes`` for ``key``, evicting LRU victims as needed.

        ``spill_fn`` must drop every device reference the key holds; it is
        called without the budget's lock held. A key larger than the whole
        budget is admitted alone rather than refused (the reference's
        overbooking escape hatch)."""
        victims = []
        with self._lock:
            if key in self._live:
                old, _ = self._live.pop(key)
                self._used -= old
            while self._used + nbytes > self.budget and self._live:
                _, (vbytes, vfn) = self._live.popitem(last=False)
                self._used -= vbytes
                victims.append((vbytes, vfn))
            self._live[key] = (nbytes, spill_fn)
            self._used += nbytes
            self.admitted += 1
            self.spill_count += len(victims)
            self.spilled_bytes += sum(v for v, _ in victims)
        for _, vfn in victims:
            vfn()

    def touch(self, key: int) -> None:
        with self._lock:
            if key in self._live:
                self._live.move_to_end(key)

    def release(self, key: int) -> None:
        with self._lock:
            if key in self._live:
                nbytes, _ = self._live.pop(key)
                self._used -= nbytes

    @property
    def used(self) -> int:
        return self._used

    def stats(self) -> dict:
        with self._lock:
            return {"budget": self.budget, "used": self._used,
                    "resident": len(self._live), "spill_count": self.spill_count,
                    "spilled_bytes": self.spilled_bytes, "admitted": self.admitted}


_BUDGET: Optional[HbmBudget] = None


def get_hbm_budget() -> Optional[HbmBudget]:
    """The installed budget, or one bootstrapped from ``CUDF_TPU_HBM_BUDGET``
    (bytes). None: device memory is not managed."""
    global _BUDGET
    if _BUDGET is None:
        env = os.environ.get("CUDF_TPU_HBM_BUDGET")
        if env:
            _BUDGET = HbmBudget(int(float(env)))
    return _BUDGET


def set_hbm_budget(budget: Optional[HbmBudget]) -> None:
    global _BUDGET
    _BUDGET = budget


def table_device_bytes(tbl) -> int:
    """Bytes of a table's buffers: each tensor's own ``nbytes`` (padding
    rows included), validity masks included."""
    total = 0
    for _, c in tbl:
        total += c.data.nbytes
        if c.validity is not None:
            total += c.validity.nbytes
    return total
