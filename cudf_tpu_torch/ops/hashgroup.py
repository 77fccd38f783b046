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

The reference module's round-synchronous table (``build_direct``,
``build_probe``, ``lookup``, ``table_bits``) is here too, as a library
off the join dispatch (joins keep the probe kernel of
``kernels/hashtable.py``). Its words are u32 patterns, in int32 or int64
tensors, as many as the caller packed. Every row of a round scatter-mins
its row id into its candidate slot (``scatter_reduce("amin")``), so the
smallest row id wins a slot on every device and run: the slots and
representatives equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.column import Column
from . import rowcodes
from .hashing import hash_operands

MAX_BITS = 64
DIRECT_BITS = 23  # direct-address table cap: 2^23 slots = 32MB of int32
_M32 = 0xFFFFFFFF
_BIG = (1 << 31) - 1  # an empty slot's representative


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


# --------------------------------------------------------------------------
# the round-synchronous table (build all rows, find each row's slot)
# --------------------------------------------------------------------------

def _u32(words) -> List[torch.Tensor]:
    return [w.to(torch.int64) & _M32 for w in words]


def table_bits(cap: int, width: int) -> Tuple[int, bool]:
    """(tbits, direct): table size for a build over ``cap`` rows."""
    if width <= DIRECT_BITS:
        return max(width, 1), True
    return max(cap.bit_length(), 7) + 1, False  # 2*capacity, load <= 0.5


def _scatter_min(T: int, slot: torch.Tensor, rowid: torch.Tensor) -> torch.Tensor:
    """int32[T]: the smallest ``rowid`` sent to each slot, _BIG where none
    (slot T is the overflow slot, cut off)."""
    out = torch.full((T + 1,), _BIG, dtype=torch.int32, device=slot.device)
    return out.scatter_reduce_(0, slot.to(torch.int64), rowid, "amin")[:T]


def build_direct(words, active: torch.Tensor, tbits: int):
    """Direct-address build: slot = the one packed word. Returns
    (slot, rep_by_slot), int32: slot T for inactive rows; rep_by_slot[s]
    the smallest active row id with key s, else INT32_MAX."""
    (w,) = _u32(words)
    T = 1 << tbits
    rowid = torch.arange(w.shape[0], dtype=torch.int32, device=w.device)
    slot = torch.where(active, w.to(torch.int32), T)
    return slot, _scatter_min(T, slot, torch.where(active, rowid, _BIG))


def _keys_eq(words, build_words, rep: torch.Tensor) -> torch.Tensor:
    src = rep.clamp(0, build_words[0].shape[0] - 1).to(torch.int64)
    eq = torch.ones(words[0].shape[0], dtype=torch.bool, device=rep.device)
    for wd, bw in zip(words, build_words):
        eq &= bw[src] == wd
    return eq


def build_probe(words, active: torch.Tensor, tbits: int):
    """Linear-probe build over all active rows. Returns (slot,
    rep_by_slot), int32. Each round every unsettled row scatter-mins its
    row id into its candidate slot; an empty slot keeps the winner as its
    representative; a row whose slot's representative has its key
    settles there, and the rest move to the next slot."""
    words = _u32(words)
    T = 1 << tbits
    cap = words[0].shape[0]
    dev = words[0].device
    rowid = torch.arange(cap, dtype=torch.int32, device=dev)
    slot = torch.where(active, (hash_operands(words) & (T - 1)).to(torch.int32), 0)
    my_slot = torch.full((cap,), T, dtype=torch.int32, device=dev)
    settled = ~active
    slot_key = torch.full((T,), -1, dtype=torch.int32, device=dev)
    for _ in range(T):
        if bool(settled.all()):
            break
        cand = _scatter_min(T, torch.where(settled, T, slot),
                            torch.where(settled, _BIG, rowid))
        slot_key = torch.where((slot_key < 0) & (cand < _BIG), cand, slot_key)
        rep = slot_key[slot.to(torch.int64)]
        newly = ~settled & _keys_eq(words, words, rep)
        my_slot = torch.where(newly, slot, my_slot)
        settled = settled | newly
        slot = torch.where(settled, slot, (slot + 1) & (T - 1))
    return my_slot, torch.where(slot_key < 0, _BIG, slot_key)


def lookup(words, active: torch.Tensor, rep_by_slot: torch.Tensor, build_words,
           tbits: int, direct: bool) -> torch.Tensor:
    """Each active row's slot in a built table (int32): the matching slot,
    or T for a miss or an inactive row. ``build_words`` are the build
    side's words, to verify keys; a row misses at the first empty slot."""
    words = _u32(words)
    T = 1 << tbits
    if direct:
        slot = words[0].to(torch.int32)
        used = rep_by_slot[slot.clamp(0, T - 1).to(torch.int64)] < _BIG
        return torch.where(active & used, slot, T)
    build_words = _u32(build_words)
    slot = (hash_operands(words) & (T - 1)).to(torch.int32)
    result = torch.full_like(slot, T)
    settled = ~active
    for _ in range(T):
        if bool(settled.all()):
            break
        rep = rep_by_slot[slot.to(torch.int64)]
        empty = rep == _BIG
        hit = ~settled & ~empty & _keys_eq(words, build_words, rep)
        result = torch.where(hit, slot, result)
        settled = settled | hit | empty
        slot = torch.where(settled, slot, (slot + 1) & (T - 1))
    return result
