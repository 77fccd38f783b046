"""Packed key words for the hash table (counterpart of the key packing of
``cudf_tpu/ops/hashgroup.py``: ``equality_ops``, ``pack_key_words``,
``pack_like``).

Each key column becomes int64 equality operands (``ops/rowcodes.py``).
Each operand is range-compressed by its min and max (over both join
sides when ``joint_with`` is given, so equal keys pack to equal words on
both sides), constant operands are dropped, and the rest are bit-packed
into one 64-bit value, handed out as two 32-bit words: ``k1`` the low
half, ``k2`` the high half, as int32 tensors holding the u32 bit pattern
(the hash table's word layout). When the widths sum past 64 there is no
packing and the caller takes the sort lane. The reference packs u32
operands into as many u32 words as it needs; the port's table takes two.

The round-synchronous hash groupby of the reference module
(``build_direct``, ``build_probe``, ``lookup``) is a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.column import Column
from . import rowcodes

MAX_BITS = 64
_M32 = 0xFFFFFFFF


def equality_ops(cols: Sequence[Column]) -> List[torch.Tensor]:
    ops: List[torch.Tensor] = []
    for c in cols:
        ops.extend(rowcodes.equality_operands(c))
    return ops


def _ranges(ops: Sequence[torch.Tensor]) -> List[Tuple[int, int]]:
    """Exact (min, max) of each int64 operand, with one host read."""
    flat = torch.stack([torch.stack([o.min(), o.max()]) for o in ops]).tolist()
    return [(lo, hi) for lo, hi in flat]


def _pack(ops: Sequence[torch.Tensor], keep, mins, widths) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k1, k2): the low and high 32 bits of the packed 64-bit key."""
    packed = torch.zeros_like(ops[0])
    for i, lo, w in zip(keep, mins, widths):
        # int64 wraps: (op - lo) mod 2^64 is the exact offset below 2^w
        v = ops[i] - lo
        packed = v if w == MAX_BITS else (packed << w) | v
    k1 = (packed & _M32).to(torch.int32)  # truncation keeps the u32 bit pattern
    k2 = ((packed >> 32) & _M32).to(torch.int32)
    return k1, k2


def pack_key_words(ops: Sequence[torch.Tensor],
                   joint_with: Optional[Sequence[torch.Tensor]] = None):
    """(words, total_bits, mins_spec, widths_spec), with words = (k1, k2);
    (None, total_bits, None, None) when the widths sum past 64.

    ``joint_with``: the other join side's operand list, whose value ranges
    share the packing; ``pack_like`` packs it with the returned specs."""
    r = _ranges(ops)
    if joint_with is not None:
        r = [(min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(r, _ranges(joint_with))]
    keep = tuple(i for i, (lo, hi) in enumerate(r) if lo != hi)
    mins = tuple(r[i][0] for i in keep)
    widths = tuple((r[i][1] - r[i][0]).bit_length() for i in keep)
    total = sum(widths)
    if total > MAX_BITS:
        return None, total, None, None
    return _pack(ops, keep, mins, widths), total, (keep, mins), (keep, widths)


def pack_like(ops: Sequence[torch.Tensor], mins_spec, widths_spec):
    """Pack another operand list with a previously computed packing."""
    keep, mins = mins_spec
    _, widths = widths_spec
    return _pack(ops, keep, mins, widths)
