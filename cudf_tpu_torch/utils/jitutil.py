"""Length plumbing for column ops (counterpart of ``cudf_tpu/utils/jitutil.py``).

PyTorch runs eagerly, so the port needs no jit wrapper; ``fix_lengths`` is
kept because operators build output columns first and learn their logical
row count (a host int) afterwards.
"""
from __future__ import annotations

from ..core.column import Column


def fix_lengths(out, length: int):
    """Walk a list/tuple/dict of Columns and set each one's length."""
    if isinstance(out, Column):
        out.length = length
        return out
    if isinstance(out, (list, tuple)):
        return type(out)(fix_lengths(o, length) for o in out)
    if isinstance(out, dict):
        return {k: fix_lengths(v, length) for k, v in out.items()}
    return out
