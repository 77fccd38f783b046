"""Order/equality key normalization ("row codes") as int64 operands.

Counterpart of ``cudf_tpu/ops/rowcodes.py``. The reference expands each key
into u32 operands because its TPU cannot bitcast f64 or sort f64 cheaply.
On the GPU each value becomes ONE int64 code whose *signed* order is the
reference's order (torch orders no unsigned 64-bit type):

  * bool / ints <= 32 bits / int64 family: the value widened to int64
  * uint64:           bits ^ INT64_MIN (unsigned order as signed order)
  * f32:              IEEE bits s, negatives flipped: s < 0 ? s ^ 0x7FFFFFFF : s
                      (the reference's ``_f32_code`` shifted by 2^31)
  * f64:              the same on 64-bit words, with the reference's
                      ``_f64_codes`` ties: -0 == +0, every NaN equal and largest
  * strings:          dictionary codes (dictionary sorted at ingest)
  * descending:       complement each code (~c reverses signed order)
  * nulls first/last: leading 0/1 null-flag operand

Semantics follow cuDF defaults: NaN sorts after +inf, null==null and
NaN==NaN for equality.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.column import Column
from ..core.dtypes import Kind
from ..core.stats import as_int64

_I32_MAX = (1 << 31) - 1
_I64_MAX = (1 << 63) - 1


def _f32_code(data: torch.Tensor) -> torch.Tensor:
    s = data.to(torch.float32).view(torch.int32)
    return torch.where(s < 0, s ^ _I32_MAX, s).to(torch.int64)


def _f64_code(x: torch.Tensor) -> torch.Tensor:
    s = x.view(torch.int64)
    code = torch.where(s < 0, s ^ _I64_MAX, s)
    code = torch.where(x == 0, torch.zeros_like(code), code)
    return torch.where(torch.isnan(x), torch.full_like(code, _I64_MAX), code)


def _value_code(col: Column) -> torch.Tensor:
    """Canonical ascending int64 order/equality code for the column values."""
    d = col.data
    k = col.dtype.kind
    if k == Kind.FLOAT:
        if col.dtype.bits == 64:
            return _f64_code(d)
        return _f32_code(d)
    if k in (Kind.BOOL, Kind.INT, Kind.UINT, Kind.TIMESTAMP, Kind.DURATION,
             Kind.DECIMAL, Kind.STRING, Kind.DICTIONARY):
        return as_int64(col)
    raise TypeError(f"cannot order {col.dtype}")


def sort_key_operands(col: Column, descending: bool,
                      nulls_last: bool) -> List[torch.Tensor]:
    """Operand list reproducing cuDF ordering for this column."""
    ops: List[torch.Tensor] = []
    if col.validity is not None:
        nk = (~col.validity).to(torch.int64)
        if not nulls_last:
            nk = 1 - nk
        ops.append(nk)
    code = _value_code(col)
    ops.append(~code if descending else code)
    return ops


def equality_operands(col: Column) -> List[torch.Tensor]:
    """Operands whose pairwise equality == cuDF row equality (null==null with
    the payload canonicalized to 0, NaN==NaN, -0 == +0)."""
    ops: List[torch.Tensor] = []
    valid = col.validity
    if valid is not None:
        ops.append((~valid).to(torch.int64))
    if col.dtype.kind == Kind.FLOAT and col.dtype.bits <= 32:
        d = col.data.to(torch.float32)
        nan = torch.isnan(d)
        code = torch.where(nan, torch.full(d.shape, _I32_MAX, dtype=torch.int64,
                                           device=d.device),
                           _f32_code(torch.where(nan, 0.0, d) + 0.0))
    else:
        code = _value_code(col)
    if valid is not None:
        code = torch.where(valid, code, torch.zeros_like(code))
    ops.append(code)
    return ops


def _oob(cap: int, length: int, device) -> torch.Tensor:
    return (torch.arange(cap, device=device) >= length).to(torch.int64)


def sort_operands(cols: Sequence[Column], descending: Sequence[bool],
                  nulls_last: Sequence[bool], length: int):
    """Full sort key-operand list; padding rows always sort last."""
    ops = [_oob(cols[0].capacity, length, cols[0].device)]
    for c, desc, nl in zip(cols, descending, nulls_last):
        ops.extend(sort_key_operands(c, desc, nl))
    return ops, len(ops)


def grouping_operands(cols: Sequence[Column], length: int) -> List[torch.Tensor]:
    """oob + equality-canonical keys (ascending, nulls last) for the
    group-identification sorts."""
    ops = [_oob(cols[0].capacity, length, cols[0].device)]
    for c in cols:
        ops.extend(equality_operands(c))
    return ops


def adjacent_neq(sorted_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool[cap]: row differs from previous row on any operand (row 0 True)."""
    first = sorted_ops[0]
    neq = torch.zeros(first.shape[0] - 1, dtype=torch.bool, device=first.device)
    for op in sorted_ops:
        neq |= op[1:] != op[:-1]
    return torch.cat([torch.ones(1, dtype=torch.bool, device=first.device), neq])
