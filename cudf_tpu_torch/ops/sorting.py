"""Sorting: sorted_order, sort_by_key, rank, top-k, segmented sort
(counterpart of ``cudf_tpu/ops/sorting.py``; libcudf's cpp/src/sort/).

Every order is a stable lexicographic sort of the keys' row codes (one
int64 code a key, a null-flag operand for a nullable key, complemented
codes for descending) by ``sortprim.multisort_perm``, then
``gather_table``. The codes are canonical: nulls are equal whatever lies
under them, -0 equals +0 and NaNs are equal, as in cuDF, pandas and the
reference's engine sort (``sort_by_key``'s code lane). The reference's
``sorted_order`` differs on two points that the port does not copy
(ROADMAP section 3): it orders null rows by the payload hidden under the
null, and an f32 -0 before +0. Padding rows must sort
last; the reference gives them a leading out-of-bounds operand, which here
would cost one more sort pass over the whole buffer. Instead every operand
of a padding row is set to INT64_MAX: the padding tuple is then the largest,
and a stable sort keeps it after any real row equal to it. The permutation
over the real rows is the reference's.

Not copied from the reference, which built them around the TPU: the
payload-carrying word lane of ``sort_by_key`` (``_fast_sort_by_key``,
``_sort_code_plan``). Its word builder is copied, because the distributed
sort ships the words and picks its splitters among them:
``build_order_words`` packs the keys' order operands, most significant
first, into 64-bit words bit for bit as the reference does, held as int64
with the top bit flipped (signed order is then the reference's unsigned
order), and ``sort_payloads_by_words`` reorders payloads by them.
``sort_by_key`` past the memory it may use sorts chunk by chunk
(``ops/chunked.py``) and gives the same permutation. ``rank`` takes each
group's start and end from a prefix sum of the group flags and a gather,
where the reference runs cummax/cummin scans (torch's cummax took 398 ms
over 2^27 rows on an H100).
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..utils.tracing import trace_op
from . import rowcodes
from .copying import gather, gather_table
from .sortprim import multisort_perm, tiled_cumsum

_I64_MAX = (1 << 63) - 1


def _norm_flags(n: int, flag: Union[bool, Sequence[bool]]) -> List[bool]:
    if isinstance(flag, (list, tuple)):
        assert len(flag) == n
        return list(flag)
    return [bool(flag)] * n


def _order_operands(keys: Sequence[Column], desc, nl) -> List[torch.Tensor]:
    """Sort operands of the keys, every operand INT64_MAX on padding rows.

    Each key's operands are its canonical equality codes
    (``rowcodes.equality_operands``, which are also order codes): a null's
    hidden payload reads as 0, -0 equals +0 and every NaN is one value,
    the largest; then the null flag flips for nulls first and the code is
    complemented for descending."""
    ops = []
    for c, d, n in zip(keys, desc, nl):
        key_ops = rowcodes.equality_operands(c)
        if c.validity is not None and not n:
            key_ops[0] = 1 - key_ops[0]
        if d:
            key_ops[-1] = ~key_ops[-1]
        ops.extend(key_ops)
    length = keys[0].length
    if length < keys[0].capacity:
        ops = [op.clone() for op in ops]
        for op in ops:
            op[length:] = _I64_MAX
    return ops


def sorted_order(keys: Sequence[Column],
                 descending: Union[bool, Sequence[bool]] = False,
                 nulls_last: Union[bool, Sequence[bool]] = True) -> torch.Tensor:
    """Stable permutation (int64[capacity]) ordering the key columns."""
    keys = list(keys)
    desc = _norm_flags(len(keys), descending)
    nl = _norm_flags(len(keys), nulls_last)
    return multisort_perm(_order_operands(keys, desc, nl))


@trace_op
def sort_by_key(tbl: Table, keys: Sequence[str],
                descending: Union[bool, Sequence[bool]] = False,
                nulls_last: Union[bool, Sequence[bool]] = True) -> Table:
    from .chunked import SORT_FACTOR, chunk_rows, chunked_sort_by_key

    rows = chunk_rows(tbl, SORT_FACTOR)
    if rows is not None:
        return chunked_sort_by_key(tbl, list(keys), _norm_flags(len(keys), descending),
                                   _norm_flags(len(keys), nulls_last), rows)
    perm = sorted_order([tbl[k] for k in keys], descending, nulls_last)
    return gather_table(tbl, perm, tbl.num_rows)


def sort_column(col: Column, descending: bool = False, nulls_last: bool = True) -> Column:
    perm = sorted_order([col], descending, nulls_last)
    return gather(col, perm, col.length)


def top_k(tbl: Table, k: int, keys: Sequence[str], largest: bool = True) -> Table:
    """cudf::top_k (cpp/src/sort/top_k.cu): sort, then the first k rows."""
    return sort_by_key(tbl, keys, descending=largest).slice(0, k)


def rank(col: Column, method: str = "min", descending: bool = False,
         pct: bool = False) -> Column:
    """cudf::rank (cpp/src/sort/rank.cu): average/min/max/first/dense; nulls
    sort last and stay null."""
    if method not in ("first", "dense", "min", "max", "average"):
        raise ValueError(method)
    cap, n = col.capacity, col.length
    dev = col.device
    perm = sorted_order([col], descending, True)
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    new_grp = rowcodes.adjacent_neq([op[perm] for op in rowcodes.equality_operands(col)])
    new_grp |= pos == n  # padding (sorted last) never joins a real group
    gid = tiled_cumsum(new_grp) - 1
    if method == "first":
        r_sorted = pos + 1
    elif method == "dense":
        r_sorted = gid + 1
    else:
        starts = torch.nonzero(new_grp).squeeze(1)
        grp_start = starts[gid]
        grp_end = (torch.cat([starts[1:], starts.new_full((1,), cap)]) - 1)[gid]
        if method == "min":
            r_sorted = grp_start + 1
        elif method == "max":
            r_sorted = grp_end + 1
        else:
            r_sorted = (grp_start + grp_end).to(torch.float64) / 2 + 1
    out = torch.empty_like(r_sorted)
    out[perm] = r_sorted
    if pct:
        valid_n = n if col.validity is None else col.valid_mask().sum()
        return Column(dtypes.float64, out.to(torch.float64) / valid_n, col.validity, n)
    out_dt = dtypes.float64 if method == "average" else dtypes.int64
    return Column(out_dt, out.to(out_dt.physical), col.validity, n)


def segmented_sorted_order(keys: Sequence[Column], offsets,
                           descending: Union[bool, Sequence[bool]] = False,
                           nulls_last: Union[bool, Sequence[bool]] = True) -> torch.Tensor:
    """Stable within-segment ordering permutation. ``offsets`` are segment
    start offsets (segment i covers rows [offsets[i], offsets[i+1])); rows
    stay inside their segment, and the keys order them within it."""
    keys = list(keys)
    desc = _norm_flags(len(keys), descending)
    nl = _norm_flags(len(keys), nulls_last)
    cap = keys[0].capacity
    dev = keys[0].device
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int64)
    seg = torch.searchsorted(offsets, torch.arange(cap, device=dev), right=True)
    return multisort_perm([seg] + _order_operands(keys, desc, nl))


def segmented_sort_by_key(tbl: Table, keys: Sequence[str], offsets,
                          descending: Union[bool, Sequence[bool]] = False,
                          nulls_last: Union[bool, Sequence[bool]] = True) -> Table:
    perm = segmented_sorted_order([tbl[k] for k in keys], offsets, descending,
                                  nulls_last)
    return gather_table(tbl, perm, tbl.num_rows)


# ---------------------------------------------------------------------------
# order words (the distributed sort's keys)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
_I64_MIN = -(1 << 63)


def _f32_order(x: torch.Tensor) -> torch.Tensor:
    """The reference's f32 order word (``rowcodes._f32_code``, NaN
    0xFFFFFFFF), of x + 0.0: -0 orders as +0, as ``sort_by_key`` has it."""
    x = x.to(torch.float32)
    u = (x + 0.0).view(torch.int32).to(torch.int64) & _U32
    code = torch.where(u >= _SIGN32, ~u & _U32, u ^ _SIGN32)
    return torch.where(torch.isnan(x), _U32, code)


def _f64_order(x: torch.Tensor) -> List[torch.Tensor]:
    """The reference's three f64 order operands (``rowcodes._f64_codes``:
    sign and exponent in 15 bits, then the top and low 26 mantissa bits,
    complemented for negatives; zero, inf and NaN have fixed codes), from
    the IEEE bits. A subnormal is normalized, so it orders between 0 and
    the smallest normal as ``sort_by_key`` has it (the reference's device
    flushes it to zero)."""
    x = x.to(torch.float64)
    s = x.view(torch.int64)
    neg = s < 0
    biased = (s >> 52) & 0x7FF
    mant = s & ((1 << 52) - 1)
    sub = (biased == 0) & (mant != 0)
    # a subnormal m·2^-1074 with m < 2^52 of bit length p + 1 is
    # (m·2^(52-p))·2^(p-1074): its fraction bits shift up into the mantissa
    p = torch.frexp(mant.to(torch.float64)).exponent.to(torch.int64) - 1
    shift = torch.where(sub, 52 - p, 0)
    mant = torch.where(sub, torch.bitwise_left_shift(mant, shift) & ((1 << 52) - 1), mant)
    e = torch.where(sub, p - 1074, biased - 1023)
    m1, m2 = mant >> 26, mant & ((1 << 26) - 1)
    base, v = 1 << 14, e + 1100
    zero = x == 0
    nan = torch.isnan(x)
    inf = torch.isinf(x)
    code1 = torch.where(neg, base - v, base + v)
    code1 = torch.where(zero, base, code1)
    code1 = torch.where(inf, torch.where(neg, base - 4000, base + 4000), code1)
    code1 = torch.where(nan, base + 8000, code1)
    mmax = (1 << 26) - 1
    special = zero | nan | inf
    mh = torch.where(special, 0, torch.where(neg, mmax - m1, m1))
    ml = torch.where(special, 0, torch.where(neg, mmax - m2, m2))
    return [code1, mh, ml]


def _order_ops(c: Column, kind: str, vmin, value_range, has_nan: bool,
               width: int, d: bool, nlast: bool):
    """(operand, width) list of one key, each operand a u32 value in an
    int64 tensor, lexicographically monotone in the requested order
    (the reference's ``sorting._order_ops``)."""
    if kind == "code":
        rng = int(value_range)
        code = (c.data.to(torch.float64) - float(vmin)).to(torch.int64)
        if has_nan:
            code = torch.where(torch.isnan(c.data), rng, code)
        r = rng + (1 if has_nan else 0)
        if d:
            code = r - 1 - code
        if c.validity is not None:
            code = (torch.where(c.validity, code, r) if nlast
                    else torch.where(c.validity, code + 1, 0))
        code = code.clamp(0, (1 << width) - 1)
        if width <= 32:
            return [(code, width)]
        return [(code >> 32, width - 32), (code & _U32, 32)]
    ops = []
    if c.validity is not None:
        nf = (~c.validity).to(torch.int64)
        ops.append((nf if nlast else 1 - nf, 1))
    if kind == "f32":
        codes = [(_f32_order(c.data), 32)]
    elif kind == "i64":
        d64 = c.data.to(torch.int64)
        codes = [(((d64 >> 32) & _U32) ^ _SIGN32, 32), (d64 & _U32, 32)]
    else:  # f64
        codes = list(zip(_f64_order(c.data), (15, 26, 26)))
    if d:
        codes = [(((1 << w) - 1) - op, w) for op, w in codes]
    return ops + codes


def _pack_words64(ops) -> List[torch.Tensor]:
    """Bit-pack (operand, width) pairs into 64-bit words, earlier operands
    in higher bits of earlier words; the last word holds its bits at the
    bottom (the reference's ``sortprim._pack_words64`` with zero minima).
    Words are raw 64-bit patterns in int64 tensors."""
    words: List[torch.Tensor] = []
    acc, used = None, 0
    for v, w in ops:
        while w > 0:
            take = min(w, 64 - used)
            piece = (v >> (w - take)) & ((1 << take) - 1)
            acc = piece if acc is None else torch.bitwise_left_shift(acc, take) | piece
            used += take
            w -= take
            if used == 64:
                words.append(acc)
                acc, used = None, 0
    if acc is not None:
        words.append(acc)
    return words


def build_order_words(kcols, plan_kinds, widths, mins, ranges, nan_flags,
                      null_flags, desc, nl, length):
    """The rows' order words for the requested order, most significant
    first, and their total bit count: a leading out-of-bounds flag (rows
    past ``length`` sort last), then each key's operands as the plan says
    (``"code"``: value - min in ``width`` bits, NaN and null codes past
    the range; ``"f32"``, ``"i64"``, ``"f64"``: a null flag where the
    column has a mask, then the value's order operands). Each word holds
    the reference's u64 bits with the top bit flipped, as int64, so signed
    order is the reference's order (torch has no ``>>`` for uint64 on the
    CPU). ``null_flags`` are taken for the reference's signature: a
    column's mask decides its null operand."""
    cap = kcols[0].capacity
    dev = kcols[0].device
    ops = [((torch.arange(cap, device=dev) >= int(length)).to(torch.int64), 1)]
    for i, c in enumerate(kcols):
        ops.extend(_order_ops(c, plan_kinds[i], mins[i], ranges[i], nan_flags[i],
                              widths[i], desc[i], nl[i]))
    words = [w ^ _I64_MIN for w in _pack_words64(ops)]
    return words, sum(w for _, w in ops)


def sort_payloads_by_words(words, payloads, pb: int, total: int):
    """``payloads`` reordered by a stable lexicographic sort of ``words``
    (most significant first). The reference embeds the row id in a
    one-word key, or runs LSD passes with a position tiebreak; either is
    this stable order, so ``pb`` and ``total`` only keep its signature."""
    perm = multisort_perm(list(words))
    return [p[perm] for p in payloads]
