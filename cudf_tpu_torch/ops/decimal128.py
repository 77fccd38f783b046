"""DECIMAL128 fixed-point arithmetic on two 64-bit limbs, with cudf's scale
rules.

Counterpart of ``cudf_tpu/ops/decimal128.py`` (fixed_point.hpp's
decimal128: an __int128 unscaled value and a power-of-ten scale). A
Decimal128Column carries two device limbs, value = hi * 2**64 + lo: ``hi``
is the int64 two's-complement high half and ``lo`` the low half, an
unsigned 64-bit word held in an int64 tensor (its bit pattern). torch's
uint64 indexes nothing on the card and has no ``>>`` on the CPU, so every
limb op works on int64 bits: adds and multiplies wrap exactly as u64 ones
do, a right shift is arithmetic and then masked, and an unsigned compare
flips the top bit of both sides first (the port's order codes do the
same). The carries of ``_add128`` come from that compare.

Scale rules are ``ops/decimal.py``'s:
  add/sub : rescale both to min(scale_l, scale_r); scale_out = min
  mul     : scale_out = scale_l + scale_r (no rescale; wraps mod 2^128)
  div     : scale_out = scale_l - scale_r (truncates toward zero)
  compare : rescale to min scale, compare unscaled

add/sub/mul/compare/rescale run on the device; a rescale divides by 10^k
in chunks of at most 10^9, so every long-division step fits in 63 bits.
General division is exact on host Python ints, as in the reference.
"""
from __future__ import annotations

import dataclasses
import decimal
from typing import List, Optional, Union

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column, resolve_device
from ..utils.padding import bucket_capacity

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_SIGN = -(1 << 63)  # the top bit, as an int64


def decimal128(scale: int = 0):
    return dtypes.DType(dtypes.Kind.DECIMAL, 128, scale)


def _i64(u: int) -> int:
    """A u64 bit pattern as the int64 that holds it."""
    u &= _MASK64
    return u - (1 << 64) if u >> 63 else u


def _split(u: int):
    """(hi, lo) int64 words of an int's low 128 bits, two's complement."""
    u &= (1 << 128) - 1
    return _i64(u >> 64), _i64(u)


@dataclasses.dataclass
class Decimal128Column:
    """Two-limb decimal column: value = (hi << 64 | lo) * 10**scale."""

    hi: torch.Tensor     # int64 high limb (sign lives here)
    lo: torch.Tensor     # int64 holding the unsigned low limb's bits
    scale: int
    validity: Optional[torch.Tensor]
    length: int

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]

    @property
    def device(self) -> torch.device:
        return self.hi.device

    @property
    def dtype(self):
        return decimal128(self.scale)

    # ------------------------------------------------------------ construct
    @classmethod
    def from_ints(cls, values, scale: int = 0, validity: Optional[np.ndarray] = None,
                  device=None) -> "Decimal128Column":
        """Host Python ints (arbitrary precision, wrapped to 128 bits) ->
        limbs; a None is a null."""
        dev = resolve_device(device)
        n = len(values)
        isnull = np.fromiter((v is None for v in values), bool, n)
        cap = bucket_capacity(max(n, 1))
        hi = np.zeros(cap, np.int64)
        lo = np.zeros(cap, np.int64)
        if n:
            words = [_split(int(v)) if v is not None else (0, 0) for v in values]
            hi[:n], lo[:n] = zip(*words)
        if validity is not None:
            isnull = isnull | ~np.asarray(validity, bool)
        v_arr = None
        if isnull.any():
            v_arr = torch.from_numpy(np.pad(~isnull, (0, cap - n))).to(dev)
        return cls(torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev), int(scale),
                   v_arr, n)

    @classmethod
    def from_decimal64(cls, col: Column) -> "Decimal128Column":
        assert col.dtype.kind == dtypes.Kind.DECIMAL and col.dtype.bits <= 64
        d = col.data.to(torch.int64)
        return cls(torch.where(d < 0, -1, 0), d, int(col.dtype.param or 0),
                   col.validity, col.length)

    def to_python(self) -> List:
        """Exact host Python ints * 10**scale (None for nulls)."""
        n = self.length
        hi = self.hi[:n].cpu().numpy().tolist()
        lo = self.lo[:n].cpu().numpy().view(np.uint64).tolist()
        v = None if self.validity is None else self.validity[:n].cpu().numpy()
        return [None if v is not None and not v[i] else (h << 64) | lo[i]
                for i, h in enumerate(hi)]

    def to_decimals(self):
        """Python decimal.Decimal values (exact)."""
        return [None if u is None else decimal.Decimal(u).scaleb(self.scale)
                for u in self.to_python()]

    def to_floats(self) -> Column:
        # the low limb's two 32-bit halves are exact in f64, so their sum
        # rounds once, as a u64 -> f64 conversion does
        lo = (((self.lo >> 32) & _MASK32).to(torch.float64) * 2.0 ** 32
              + (self.lo & _MASK32).to(torch.float64))
        x = self.hi.to(torch.float64) * (2.0 ** 64) + lo
        return Column(dtypes.float64, x * (10.0 ** self.scale), self.validity, self.length)

    def to_strings(self) -> Column:
        from .decimal import format_unscaled

        out = [None if u is None else format_unscaled(u, self.scale)
               for u in self.to_python()]
        return Column.from_numpy(np.array(out, object), device=self.device)


# ---------------------------------------------------------------------------
# limb primitives on int64 words (adds and multiplies wrap mod 2^64)
# ---------------------------------------------------------------------------

def _ult(a, b):
    """Unsigned a < b of two 64-bit words."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr32(x):
    """Logical x >> 32 of a 64-bit word."""
    return (x >> 32) & _MASK32


def _add128(hl, ll, hr, lr):
    lo = ll + lr
    return hl + hr + _ult(lo, ll).to(torch.int64), lo


def _neg128(h, l):
    lo = ~l + 1
    return ~h + (lo == 0).to(torch.int64), lo


def _sub128(hl, ll, hr, lr):
    nh, nl = _neg128(hr, lr)
    return _add128(hl, ll, nh, nl)


def _mulu64_full(a, b):
    """(hi, lo) of the unsigned 128-bit product a*b, via 32-bit halves."""
    a0, a1 = a & _MASK32, _shr32(a)
    b0, b1 = b & _MASK32, _shr32(b)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _shr32(p00) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | (mid << 32)
    hi = p11 + _shr32(p01) + _shr32(p10) + _shr32(mid)
    return hi, lo


def _mul128(hl, ll, hr, lr):
    """Low 128 bits of the signed product (cudf overflow semantics: wrap)."""
    hi_u, lo = _mulu64_full(ll, lr)
    return hi_u + hl * lr + ll * hr, lo


def _lt128(hl, ll, hr, lr):
    return (hl < hr) | ((hl == hr) & _ult(ll, lr))


def _muldiv_chunks(k: int) -> List[int]:
    """10**k as factors each <= 10**9 (long-division steps stay in 63 bits)."""
    out = []
    while k > 9:
        out.append(10 ** 9)
        k -= 9
    if k:
        out.append(10 ** k)
    return out


def _mul128_u32const(h, l, c: int):
    hi_u, lo = _mulu64_full(l, c)
    return hi_u + h * c, lo


def _divmod128_u32const(h, l, c: int):
    """Unsigned (h, l) // c and the remainder, c <= 10**9: four 32-bit limb
    steps. r < c < 2^30, so each step's dividend is below 2^62 and a signed
    division is exact."""
    r = torch.zeros_like(l)
    q = []
    for limb in (_shr32(h), h & _MASK32, _shr32(l), l & _MASK32):
        acc = (r << 32) | limb
        q.append(acc // c)
        r = acc - q[-1] * c
    return (q[0] << 32) | q[1], (q[2] << 32) | q[3], r


def _rescale128(h, l, from_scale: int, to_scale: int, round_half: bool):
    if to_scale == from_scale:
        return h, l
    if to_scale < from_scale:
        for c in _muldiv_chunks(from_scale - to_scale):
            h, l = _mul128_u32const(h, l, c)
        return h, l
    # divide by 10^(to-from) on the magnitude; optionally round half away
    # from zero by adding half the whole divisor first
    neg = h < 0
    nh, nl = _neg128(h, l)
    ah, al = torch.where(neg, nh, h), torch.where(neg, nl, l)
    if round_half:
        hh, hl_ = _split((10 ** (to_scale - from_scale)) // 2)
        ah, al = _add128(ah, al, hh, hl_)
    for c in _muldiv_chunks(to_scale - from_scale):
        ah, al, _ = _divmod128_u32const(ah, al, c)
    nh, nl = _neg128(ah, al)
    return torch.where(neg, nh, ah), torch.where(neg, nl, al)


def _binop128(hl, ll, hr, lr, sl, sr, op):
    if op == "mul":
        return _mul128(hl, ll, hr, lr)
    s = min(sl, sr)
    hl, ll = _rescale128(hl, ll, sl, s, False)
    hr, lr = _rescale128(hr, lr, sr, s, False)
    if op == "add":
        return _add128(hl, ll, hr, lr)
    if op == "sub":
        return _sub128(hl, ll, hr, lr)
    lt = _lt128(hl, ll, hr, lr)
    eq = (hl == hr) & (ll == lr)
    cmp = {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt}
    if op not in cmp:
        raise ValueError(op)
    return cmp[op], None


def binary_op(lhs: Decimal128Column, rhs: Union[Decimal128Column, int], op: str):
    """cudf fixed_point binary op on decimal128 columns."""
    if isinstance(rhs, int):
        h, l = _split(rhs)
        rhs = Decimal128Column(torch.full_like(lhs.hi, h), torch.full_like(lhs.lo, l), 0,
                               None, lhs.length)
    v = lhs.validity
    if rhs.validity is not None:
        v = rhs.validity if v is None else v & rhs.validity
    sl, sr = lhs.scale, rhs.scale
    if op == "div":
        # exact host division (truncate toward zero), scale = sl - sr
        out = []
        for a, b in zip(lhs.to_python(), rhs.to_python()):
            if a is None or b is None or b == 0:
                out.append(None)
            else:
                q = abs(a) // abs(b)
                out.append(-q if (a < 0) != (b < 0) else q)
        return Decimal128Column.from_ints(out, sl - sr, device=lhs.device)
    h, l = _binop128(lhs.hi, lhs.lo, rhs.hi, rhs.lo, sl, sr, op)
    if l is None:  # a comparison
        return Column(dtypes.bool_, h, v, lhs.length)
    out_scale = {"add": min(sl, sr), "sub": min(sl, sr), "mul": sl + sr}[op]
    return Decimal128Column(h, l, out_scale, v, lhs.length)


def rescale(col: Decimal128Column, to_scale: int) -> Decimal128Column:
    """fixed_point::rescaled (round half away from zero on narrowing)."""
    h, l = _rescale128(col.hi, col.lo, col.scale, int(to_scale), True)
    return Decimal128Column(h, l, int(to_scale), col.validity, col.length)


def order_operands(col: Decimal128Column) -> List[torch.Tensor]:
    """int64 sort and equality operands for ``sortprim.multisort_perm``:
    the signed high limb, then the low limb with its top bit flipped into
    signed order. They order rows as the reference's four u32 operands do."""
    return [col.hi, col.lo ^ _SIGN]
