"""Capacity bucketing for column buffers.

Counterpart of ``cudf_tpu/utils/padding.py``. CUDA kernels take runtime
sizes, so the GPU needs no static shapes; the port keeps the power-of-two
capacities anyway because operators read ``capacity`` as semantics (the
bit width of a row position, ``_posbits(cap)``, decides which groupby lane
fits a key), and results must match the reference lane for lane.
"""
from __future__ import annotations

LANE = 128


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= max(n, 128)."""
    if n <= LANE:
        return LANE
    p = LANE
    while p < n:
        p *= 2
    return p
