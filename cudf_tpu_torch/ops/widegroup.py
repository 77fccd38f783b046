"""Wide-key groupby: the sparse and 64-bit-key lane (counterpart of
``cudf_tpu/ops/widegroup.py``).

The code-sort lanes (``sortgroup``, ``fastgroup``) need every key
integral-codeable within a small joint range, sized from column stats.
Random 64-bit surrogate ids, full-range floats and wide multi-key sets fail
that plan; this lane groups them with no range assumption:

  1. each key becomes the port's equality codes (``rowcodes.equality_operands``:
     a null flag where the column has a mask, then one int64 code), cut to
     unsigned pieces of at most 32 bits whose order is the key's order;
  2. only the rows below the length are sorted; under ``dropna`` with a
     nullable key a leading flag marks the rows with a null key (they sort
     last and are left out), and the keys' own null flags are dropped;
     flag and pieces bit-pack into at most ``MAX_WORDS`` 64-bit words
     (``sorting._pack_words64``), a full word's top bit flipped so that
     signed order is its unsigned order;
  3. one stable ``torch.sort`` a word, least significant first, composes
     one permutation (a word of few bits sorts in a narrower dtype);
  4. group starts are where adjacent sorted words differ; every payload is
     gathered once by the permutation, and the aggregates are the code-sort
     lanes' own (``fastgroup.build_scan_arrays`` and ``_finish_agg``), so
     ``var``, ``first`` or ``argmin`` mean the same on this lane and the
     code-sort lanes (the generic engine computes its own).

The reference carries every payload through each sort pass, because
gathers were slow on its stack; here one gather a payload follows the
sorts. The codes order ascending with nulls last, so groups come out in
pandas ``sort=True`` order. ``op_widths`` keeps the reference's static
widths, and a plan is refused exactly where the reference refuses it; the
port's codes are never wider (an int64 key is 64 bits against the
reference's 32 + 32, an f64 key 64 against 15 + 26 + 26), so whatever the
reference accepts fits the port's words.

``wide_groupby.launches`` counts the times the lane answered.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.column import Column
from ..core.dtypes import Kind
from ..core.table import Table
from . import fastgroup, rowcodes
from .sorting import _pack_words64

MAX_WORDS = 3  # up to 3 LSD passes (e.g. two i64 keys + null flags)

_M32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
_I64_MIN = -(1 << 63)


def op_widths(col: Column) -> Optional[List[int]]:
    """The reference's static bit widths of its equality operands for
    ``col``, or None for kinds the operand encoding does not cover
    (lists, structs)."""
    if not isinstance(col, Column):
        return None
    w: List[int] = []
    if col.validity is not None:
        w.append(1)
    k = col.dtype.kind
    if k == Kind.BOOL:
        w.append(1)
    elif k in (Kind.STRING, Kind.DICTIONARY):
        nd = len(col.dictionary) if col.dictionary is not None else 0
        w.append(max(1, (max(nd - 1, 1)).bit_length()))
    elif k == Kind.FLOAT:
        if col.dtype.bits == 64:
            w.extend([15, 26, 26])
        else:
            w.append(32)
    elif k == Kind.UINT:
        w.extend([32, 32] if col.dtype.bits == 64 else [32])
    elif k in (Kind.INT, Kind.TIMESTAMP, Kind.DURATION, Kind.DECIMAL):
        if col.dtype.bits <= 32 and k == Kind.INT:
            w.append(32)
        else:
            w.extend([32, 32])
    else:
        return None
    return w


def _code_pieces(col: Column, n: int, null_flag: bool) -> List[Tuple[torch.Tensor, int]]:
    """(piece, width) pairs of one key's first ``n`` rows: non-negative
    int64 pieces whose lexicographic order is the key's order, nulls after
    every value (the null flag first when ``null_flag``)."""
    ops = [op[:n] for op in rowcodes.equality_operands(col)]
    pieces = [(ops[0], 1)] if col.validity is not None and null_flag else []
    code = ops[-1]
    k, bits = col.dtype.kind, col.dtype.bits
    if k == Kind.BOOL:
        pieces.append((code, 1))
    elif k in (Kind.STRING, Kind.DICTIONARY):
        pieces.append((code, op_widths(col)[-1]))
    elif (k == Kind.FLOAT and bits <= 32) or (k == Kind.INT and bits <= 32):
        pieces.append((code + _SIGN32, 32))  # signed 32-bit order, shifted
    elif k == Kind.UINT and bits <= 32:
        pieces.append((code, 32))
    else:  # 64-bit codes: unsigned order in two 32-bit halves
        u = code ^ _I64_MIN
        pieces.extend([((u >> 32) & _M32, 32), (u & _M32, 32)])
    return pieces


def _narrow(word: torch.Tensor, bits: int) -> torch.Tensor:
    """A word of ``bits`` < 64 non-negative bits in the narrowest signed
    dtype that holds it: a radix sort's passes scale with the key's bytes."""
    for dt, room in ((torch.int16, 15), (torch.int32, 31)):
        if bits <= room:
            return word.to(dt)
    return word


def _sort_words(words: Sequence[torch.Tensor], bits: Sequence[int]):
    """Stable lexicographic permutation of the rows by ``words`` (most
    significant first), one stable sort a word, least significant first;
    returns it and the words in sorted order."""
    perm = top = None
    for w, b in zip(reversed(words), reversed(bits)):
        key = _narrow(w if perm is None else w[perm], b)
        top, order = torch.sort(key, stable=True)
        perm = order if perm is None else perm[order]
    return perm, [top] + [w[perm] for w in words[1:]]


def wide_groupby(tbl: Table, keys: Sequence[str], aggs,
                 dropna_keys: bool) -> Optional[Table]:
    """Sparse/wide-key groupby; None when this plan doesn't apply."""
    if not all(s.kind in fastgroup._SUPPORTED for s in aggs):
        return None
    kcols = [tbl[k] for k in keys]
    total = 1  # the reference's leading inactive flag
    for c in kcols:
        w = op_widths(c)
        if w is None:
            return None
        total += sum(w)
    if -(-total // 64) > MAX_WORDS:
        return None

    # Rows past the length are never sorted. Under dropna a leading flag
    # sends the rows with a null key last, and the keys' own null flags,
    # constant over the rows that remain, are dropped.
    rows = kcols[0].length
    dev = kcols[0].device
    inactive = None
    if dropna_keys and any(c.validity is not None for c in kcols):
        inactive = torch.zeros(rows, dtype=torch.bool, device=dev)
        for c in kcols:
            if c.validity is not None:
                inactive |= ~c.validity[:rows]
    pieces = [] if inactive is None else [(inactive.to(torch.int64), 1)]
    for c in kcols:
        pieces.extend(_code_pieces(c, rows, inactive is None))
    words = _pack_words64(pieces)
    nbits = sum(w for _, w in pieces)
    bits = [64] * (len(words) - 1) + [nbits - 64 * (len(words) - 1)]
    # a full word sorts in signed order once its top bit is flipped
    words = [w ^ _I64_MIN if b == 64 else w for w, b in zip(words, bits)]
    pos, swords = _sort_words(words, bits)

    act = torch.ones(rows, dtype=torch.bool, device=dev) if inactive is None else ~inactive[pos]
    newgrp = rowcodes.adjacent_neq(swords) & act if rows else act
    out, starts, n_groups = fastgroup.aggregate_sorted(tbl, keys, aggs, pos, act, newgrp)
    idx = pos[starts]
    for name, c in zip(keys, kcols):
        data = c.data[idx]
        validity = None
        if c.validity is not None:
            validity = c.validity[idx]
            data = torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                           device=data.device))
        out[name] = fastgroup.padded_column(c.dtype, data, validity, n_groups,
                                            c.dictionary)
    wide_groupby.launches += 1
    return Table({n: out[n] for n in list(keys) + [s.out_name for s in aggs]})


wide_groupby.launches = 0
