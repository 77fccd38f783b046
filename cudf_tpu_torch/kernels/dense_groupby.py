"""Dense-slot groupby sums and counts, one pass with no sort (no counterpart
in ``cudf_tpu/kernels/``: the reference sums float64 and integer columns
on its sort lanes, with XLA's sort and segment sums).

``dense_groupby(keys, accs, n, n_slots, dropna)`` returns int64
``[n_slots, A]``: for each slot, the accumulators ``accs`` over the first
``n`` rows whose packed key code is that slot. A key (``Key``) codes as
``ops/fastgroup.py:_key_code`` does: value - vmin, the NaN and null codes
above the range, clamped to its width, the first key most significant;
under ``dropna`` a row with a null key reaches no slot. An accumulator
(``Acc``) is the row count (``ROWS``), a float64 sum of a float column
(``SUM_F``, its bits in the int64 output), an int64 sum of an integer or
bool column (``SUM_I``, wrapping as two's complement) or the valid count
of a nullable column (``COUNT``). A null value adds to neither.

On a CUDA tensor it launches the hand-written kernel
(``csrc/dense_groupby.cu``: each thread's own float64 accumulators in
shared memory up to ``THREAD_SLOTS`` of them where no sum is an integer
one, else each warp's copy; no atomics, so the same bits on every run;
its bound is in the source). It was added because keys that pack into at
most 11 code bits are group ids already, and the sort lane sorted,
gathered and reduced the whole capacity to find them. On a CPU tensor it
runs ``dense_groupby_plain``, the same function in plain PyTorch and the
kernel's oracle: it folds each slot's rows in row order (``index_add_``),
so its float sums are the bits of the sort lane's sums on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from . import KernelError, entry, on_device, stream_of

MAX_SLOTS = 2048         # 2^11: the lane's packed key width
MAX_KEYS = 8
MAX_VALUES = 16          # value columns: a sum and a count each, beside the row count
MAX_ACCS = 1 + 2 * MAX_VALUES
THREAD_SLOTS = 48        # thread tier: K·A accumulators a thread holds
THREAD_MAX_A = 16
_SMEM_BYTES = 226 * 1024  # a block's shared memory on the H100 after opt-in, less 1 KB static
_WARPS = 8               # warps of a warp-tier block where they fit

ROWS, SUM_F, SUM_I, COUNT = 0, 1, 2, 3
# the kernel's dtype codes (csrc/dense_groupby.cu)
DTYPES = {torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3, torch.uint16: 4,
          torch.int32: 5, torch.uint32: 6, torch.int64: 7, torch.uint64: 8,
          torch.bfloat16: 9, torch.float32: 10, torch.float64: 11}
FLOATS = (torch.bfloat16, torch.float32, torch.float64)
_I64_MIN = -(1 << 63)


@dataclasses.dataclass(frozen=True)
class Key:
    """One key column: ``data`` (its physical values) and ``validity``
    (bool, or None), at least n rows each; ``vmin`` in the key's code
    domain (a float for float keys, else an int in ``colstats.as_int64``'s
    order-preserving domain); the code ``width`` in bits; the NaN and null
    codes."""
    data: torch.Tensor
    validity: Optional[torch.Tensor]
    vmin: int | float
    width: int
    nan_code: int
    null_code: int


@dataclasses.dataclass(frozen=True)
class Acc:
    """One accumulator: ``kind`` (ROWS, SUM_F, SUM_I, COUNT) over ``data``
    and ``validity`` (None for ROWS; ``validity`` None when the column has
    no nulls)."""
    kind: int
    data: Optional[torch.Tensor] = None
    validity: Optional[torch.Tensor] = None


def tier(n_slots: int, kinds: Sequence[int]) -> Optional[int]:
    """0 for the thread tier (each thread's [K, A] accumulators in float64,
    so no integer sum), else the warps of a warp-tier block: each warp holds
    a 64-bit copy of the [K, A] accumulators in shared memory. None when the
    slots or the accumulators fit no tier."""
    n_accs = len(kinds)
    if not (1 <= n_slots <= MAX_SLOTS and 1 <= n_accs <= MAX_ACCS):
        return None
    S = n_slots * n_accs
    if S <= THREAD_SLOTS and n_accs <= THREAD_MAX_A and SUM_I not in kinds:
        return 0
    warps = min(_WARPS, _SMEM_BYTES // (S * 8))
    return warps if warps >= 1 else None


def _codes(k: Key, n: int) -> torch.Tensor:
    d = k.data[:n]
    if d.dtype in FLOATS:
        code = (d.to(torch.float64) - k.vmin).to(torch.int64)
        code = torch.where(torch.isnan(d), k.nan_code, code)
    else:
        x = d.view(torch.int64) ^ _I64_MIN if d.dtype == torch.uint64 else d.to(torch.int64)
        code = x - k.vmin
    if k.validity is not None:
        code = torch.where(k.validity[:n], code, k.null_code)
    return code.clamp(0, (1 << k.width) - 1)


def _terms(a: Acc, n: int, dev) -> torch.Tensor:
    """Each row's term of one accumulator (f64 or int64)."""
    if a.kind == ROWS:
        return torch.ones(n, dtype=torch.int64, device=dev)
    if a.kind == COUNT:
        return a.validity[:n].to(torch.int64)
    d = a.data[:n]
    if a.kind == SUM_F:
        x, zero = d.to(torch.float64), 0.0
    else:
        x, zero = (d.view(torch.int64) if d.dtype == torch.uint64 else d.to(torch.int64)), 0
    return x if a.validity is None else torch.where(a.validity[:n], x, zero)


def dense_groupby_plain(keys: Sequence[Key], accs: Sequence[Acc], n: int, n_slots: int,
                        dropna: bool) -> torch.Tensor:
    """Plain PyTorch version: each accumulator's terms ``index_add_``-ed into
    its slot, in row order; rows with no slot go to an overflow row that is
    cut off."""
    dev = keys[0].data.device
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for k in keys:
        slot = (slot << k.width) | _codes(k, n)
        if dropna and k.validity is not None:
            active &= k.validity[:n]
    idx = torch.where(active, slot, n_slots)
    out = torch.zeros((n_slots, len(accs)), dtype=torch.int64, device=dev)
    for j, a in enumerate(accs):
        x = _terms(a, n, dev)
        s = torch.zeros(n_slots + 1, dtype=x.dtype, device=dev).index_add_(0, idx, x)
        out[:, j] = s[:n_slots].view(torch.int64)
    return out


def _tensors(keys, accs):
    for k in keys:
        yield k.data
        yield k.validity
    for a in accs:
        yield a.data
        yield a.validity


def _check(keys, accs, n, n_slots):
    ts = [t for t in _tensors(keys, accs) if t is not None]
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev}, {t.device}")
        if t.ndim != 1 or not t.is_contiguous() or t.shape[0] < n:
            raise ValueError(f"every column must be contiguous with at least {n} rows, "
                             f"got {list(t.shape)}")
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"1 to {MAX_KEYS} keys, got {len(keys)}")
    for k in keys:
        if k.data.dtype not in DTYPES:
            raise TypeError(f"no key of {k.data.dtype}")
        if k.validity is not None and k.validity.dtype != torch.bool:
            raise TypeError("validity must be bool")
    if sum(k.width for k in keys) > MAX_SLOTS.bit_length() - 1 or \
            n_slots != 1 << sum(k.width for k in keys):
        raise ValueError(f"{n_slots} slots for key widths {[k.width for k in keys]}")
    for a in accs:
        if a.kind == ROWS:
            continue
        if a.kind == COUNT:
            if a.validity is None or a.validity.dtype != torch.bool:
                raise TypeError("a count needs a bool validity")
            continue
        if a.kind not in (SUM_F, SUM_I) or a.data is None:
            raise ValueError(f"unknown accumulator {a.kind}")
        if a.data.dtype not in DTYPES or (a.kind == SUM_F) != (a.data.dtype in FLOATS):
            raise TypeError(f"no {'float' if a.kind == SUM_F else 'integer'} sum of "
                            f"{a.data.dtype}")
        if a.validity is not None and a.validity.dtype != torch.bool:
            raise TypeError("validity must be bool")
    if tier(n_slots, [a.kind for a in accs]) is None:
        raise ValueError(f"[{n_slots}, {len(accs)}] accumulators fit no tier")
    return dev


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def dense_groupby(keys: Sequence[Key], accs: Sequence[Acc], n: int, n_slots: int,
                  dropna: bool) -> torch.Tensor:
    """int64 [n_slots, len(accs)]: each slot's accumulators over the first n
    rows (a float64 sum as its bits)."""
    dev = _check(keys, accs, n, n_slots)
    if dev.type == "cpu":
        return dense_groupby_plain(keys, accs, n, n_slots, dropna)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    A = len(accs)
    out = torch.empty((n_slots, A), dtype=torch.int64, device=dev)
    if n == 0:
        return out.zero_()
    warps = tier(n_slots, [a.kind for a in accs])
    LL = ctypes.c_longlong
    key_ptrs = (LL * (2 * len(keys)))(*[p for k in keys for p in (_ptr(k.data), _ptr(k.validity))])
    key_ints = (LL * (5 * len(keys)))(*[
        v for k in keys for v in (DTYPES[k.data.dtype], k.width,
                                  0 if k.data.dtype in FLOATS else int(k.vmin),
                                  k.nan_code, k.null_code)])
    key_vminf = (ctypes.c_double * len(keys))(
        *[float(k.vmin) if k.data.dtype in FLOATS else 0.0 for k in keys])
    acc_ptrs = (LL * (2 * A))(*[p for a in accs for p in (_ptr(a.data), _ptr(a.validity))])
    acc_ints = (ctypes.c_int * (2 * A))(*[
        v for a in accs for v in (DTYPES[a.data.dtype] if a.data is not None else 0, a.kind)])
    blocks = ctypes.c_int(0)
    with on_device(dev):
        err = entry("dense_groupby", "dense_groupby_blocks")(n, A, n_slots, warps,
                                                              ctypes.byref(blocks))
        if err == 0:
            partials = torch.empty(blocks.value * n_slots * A, dtype=torch.int64, device=dev)
            err = entry("dense_groupby", "dense_groupby_sums")(
                key_ptrs, key_ints, key_vminf, len(keys), acc_ptrs, acc_ints, A, n, n_slots,
                int(dropna), warps, blocks.value, partials.data_ptr(), out.data_ptr(),
                stream_of(dev))
    if err != 0:
        raise KernelError(f"dense_groupby launch failed: CUDA error {err}")
    dense_groupby.launches += 1
    return out


dense_groupby.launches = 0  # kernel launches; chip_smoke.py and the card tests read it
