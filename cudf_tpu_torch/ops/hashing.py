"""Row hashing: murmur3-style u32 hashes (counterpart of
``cudf_tpu/ops/hashing.py``).

Analog of cpp/src/hash/ (murmurhash3_x86_32.cu) and the row-operator
hashing path (cpp/src/row_operator/hashing.cuh). A row hashes the words of
the reference's u32 equality operands (``cudf_tpu/ops/rowcodes.py``), so
the hashes equal the reference's bit for bit and hash equality follows row
equality (null == null, NaN == NaN, -0 == +0), the property hash
partitioning depends on. Per key column the words are: a null flag when
the column has a validity mask, then one word for bool, 8-32-bit ints, f32,
strings and categories, two (high, low) for 64-bit ints, timestamps,
durations and decimals, and three for f64 (sign and exponent, two 26-bit
mantissa chunks); a null row's value words are 0. The port's own row
codes are one int64 per column (``ops/rowcodes.py``), so the words are
rebuilt here from the values.

Words live in int64 tensors holding values in [0, 2^32): torch has no
``>>`` for unsigned types on the CPU, and a 32-bit product is formed from
16-bit halves, so no int64 product overflows. Subnormals hash as zero, as
in the reference, whose f64 codes and f32 canonicalization see none.

Faults of the reference not copied: its ``hash_values`` drops its
``seed``, where here the seed enters the hash, as in cuDF (equal to the
reference's ``hash_columns(cols, seed)``); and its jitted hash folds the
``x + 0.0`` of its f32 word away, so an f32 -0 hashes apart from +0, where
here -0 hashes as +0, as row equality requires.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import Kind

_MASK = 0xFFFFFFFF
_SIGN32 = 1 << 31
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_F32_MIN_NORMAL = 1.1754943508222875e-38
_F64_MIN_NORMAL = 2.2250738585072014e-308


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for words x and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_operands(ops: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Murmur3-x86-32 combine of u32 words (int64 tensors) into a u32 hash
    (an int64 tensor in [0, 2^32))."""
    h = torch.full(ops[0].shape, seed & _MASK, dtype=torch.int64, device=ops[0].device)
    for op in ops:
        k = _mul32(_rotl32(_mul32(op, _C1), 15), _C2)
        h = _rotl32(h ^ k, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & _MASK
    return _fmix32(h ^ (4 * len(ops)))


def _f32_word(x: torch.Tensor) -> torch.Tensor:
    """The reference's f32 equality word: NaN 0xFFFFFFFF, else the order
    code of x + 0.0 (so -0 is +0; subnormals flushed to 0)."""
    x = x.to(torch.float32)
    nan = torch.isnan(x)
    x = torch.where(nan | (x.abs() < _F32_MIN_NORMAL), 0.0, x) + 0.0
    u = x.view(torch.int32).to(torch.int64) & _MASK
    code = torch.where(u >= _SIGN32, ~u & _MASK, u ^ _SIGN32)
    return torch.where(nan, _MASK, code)


def _f64_words(x: torch.Tensor) -> List[torch.Tensor]:
    """The reference's three f64 order words (``_f64_codes``), from the
    IEEE bits: sign and exponent, then the top and low 26 mantissa bits,
    complemented for negatives; zero, inf and NaN have fixed codes."""
    s = x.view(torch.int64)
    neg = s < 0
    a = x.abs()
    zero = a < _F64_MIN_NORMAL
    nan = torch.isnan(x)
    inf = torch.isinf(x)
    e = ((s >> 52) & 0x7FF) - 1023
    mant = s & ((1 << 52) - 1)
    m1, m2 = mant >> 26, mant & ((1 << 26) - 1)
    base = 1 << 14
    v = e + 1100
    code1 = torch.where(neg, base - v, base + v)
    code1 = torch.where(zero, base, code1)
    code1 = torch.where(inf, torch.where(neg, base - 4000, base + 4000), code1)
    code1 = torch.where(nan, base + 8000, code1)
    mmax = (1 << 26) - 1
    special = zero | nan | inf
    mh = torch.where(special, 0, torch.where(neg, mmax - m1, m1))
    ml = torch.where(special, 0, torch.where(neg, mmax - m2, m2))
    return [code1, mh, ml]


def _hi_lo(d64: torch.Tensor, signed: bool) -> List[torch.Tensor]:
    hi = (d64 >> 32) & _MASK
    return [hi ^ _SIGN32 if signed else hi, d64 & _MASK]


def _value_words(col: Column) -> List[torch.Tensor]:
    d = col.data
    k = col.dtype.kind
    if k == Kind.FLOAT:
        return _f64_words(d) if col.dtype.bits == 64 else [_f32_word(d)]
    if k == Kind.UINT and col.dtype.bits == 64:
        return _hi_lo(d.view(torch.int64), signed=False)
    if k in (Kind.BOOL, Kind.UINT, Kind.STRING, Kind.DICTIONARY):
        return [d.to(torch.int64) & _MASK]
    if k == Kind.INT and col.dtype.bits <= 32:
        return [(d.to(torch.int64) & _MASK) ^ _SIGN32]
    if k in (Kind.INT, Kind.TIMESTAMP, Kind.DURATION, Kind.DECIMAL):
        return _hi_lo(d.to(torch.int64), signed=True)
    raise TypeError(f"cannot hash {col.dtype}")


def equality_words(col: Column) -> List[torch.Tensor]:
    """The column's u32 equality words, as the reference's
    ``rowcodes.equality_operands`` gives them."""
    words = _value_words(col)
    if col.validity is None:
        return words
    return [(~col.validity).to(torch.int64)] + [
        torch.where(col.validity, w, 0) for w in words]


def hash_columns(cols: Sequence[Column], seed: int = 0) -> torch.Tensor:
    """u32 row hash (int64 tensor) consistent with row equality."""
    ops: List[torch.Tensor] = []
    for c in cols:
        ops.extend(equality_words(c))
    return hash_operands(ops, seed)


def hash_values(cols: Sequence[Column], seed: int = 0) -> Column:
    """cudf.DataFrame.hash_values analog (murmur3 per row), uint32."""
    out = hash_columns(cols, seed).to(torch.int32).view(torch.uint32)
    return Column(dtypes.uint32, out, None, cols[0].length)


def partition_ids(cols: Sequence[Column], n_parts: int) -> torch.Tensor:
    """Hash-partition assignment, int32 (cpp/src/partitioning/partitioning.cu)."""
    return (hash_columns(cols) % n_parts).to(torch.int32)
