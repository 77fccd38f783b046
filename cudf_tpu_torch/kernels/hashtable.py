"""Linear-probing hash table for distinct-key build sides (counterpart of
``cudf_tpu/kernels/hashtable.py``; the cuco::static_set of libcudf's
distinct_hash_join.cu).

Contents as in the reference: open addressing over a power-of-two number
of slots, two 32-bit key words and an int32 payload per slot, ``EMPTY``
(INT32_MIN) marking a vacant slot. Layout: one 16 B slot, ``int32[m+1, 4]``
rows of (tk1, tk2, payload, 0), so the probe kernel reads a slot with one
vector load; ``build_table`` hands out its columns 0-2 as views. torch has
no unsigned 32-bit arithmetic on the CPU, so key words are int32 tensors
holding the u32 bit pattern; the hash ``_mix`` runs in int64 and masks to
32 bits after every multiply (int64 multiplication wraps, and its low 32
bits are the u32 product), so it equals the reference's u32 ``_mix`` bit
for bit.

* ``build_table`` — plain PyTorch: rounds of ``scatter_reduce_("amin")``,
  in which every unplaced row bids its row id for slot ``(h + i) & (m-1)``;
  the smallest bid wins a vacant slot, so a duplicate key keeps its
  smallest row id. The rounds stop once every row is placed (a placed row
  never wins again, so the remaining rounds of the reference change
  nothing).
* ``probe_table`` — on a CUDA tensor the hand-written kernel
  (``csrc/hashtable_probe.cu``) over the slot tensor: the views'
  base where the table is ``build_table``'s, else the three arrays packed
  into one once; on a CPU tensor ``probe_table_plain``, the same 16
  vectorized probe rounds as the Pallas body.
"""
from __future__ import annotations

import ctypes

import torch

from . import load_library

MAX_PROBE = 16
EMPTY = -2147483648  # vacant-slot payload sentinel (INT32_MIN)
_M32 = 0xFFFFFFFF
_BIG = (1 << 31) - 1


def _mix(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """u32 murmur-style hash of two key words, as int64 in [0, 2^32)."""
    a = h1.to(torch.int64) & _M32
    b = h2.to(torch.int64) & _M32
    h = ((a * 0xCC9E2D51) & _M32) ^ ((b * 0x1B873593) & _M32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    return h ^ (h >> 13)


def table_size_for(n_build: int) -> int:
    """Power-of-two size at <= 50% load."""
    m = 1
    while m < max(2 * n_build, 16):
        m *= 2
    return m


def build_table(k1: torch.Tensor, k2: torch.Tensor, valid: torch.Tensor, m: int):
    """Insert rows (k1[i], k2[i]) -> i for valid rows into m slots.

    Returns (tk1, tk2, payload, all_placed): int32[m] each, columns 0-2 of
    one 16 B-aligned ``int32[m+1, 4]`` slot tensor whose column 3 is 0, and
    a bool; ``all_placed`` is False when some row found no slot in
    MAX_PROBE probes. Slot m is the overflow slot of the reference's
    ``mode="drop"`` scatter; it is sliced off."""
    if m & (m - 1) or m < 1:
        raise ValueError(f"table size must be a power of two, got {m}")
    dev = k1.device
    h = _mix(k1, k2)
    slots = torch.zeros((m + 1, 4), dtype=torch.int32, device=dev)
    slots[:, 2] = EMPTY
    tk1, tk2, payload = slots[:, 0], slots[:, 1], slots[:, 2]
    pending = torch.nonzero(valid).squeeze(1)  # unplaced row ids, ascending
    for i in range(MAX_PROBE):
        if pending.numel() == 0:
            break
        slot = (h[pending] + i) & (m - 1)
        claim = torch.full((m,), _BIG, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, slot, pending, "amin")
        won = (claim[slot] == pending) & (payload[slot] == EMPTY)
        dst = torch.where(won, slot, m)
        payload[dst] = torch.where(won, pending, 0).to(torch.int32)
        tk1[dst] = torch.where(won, k1[pending], 0)
        tk2[dst] = torch.where(won, k2[pending], 0)
        # a row is placed once its key is in the table (covers duplicates)
        present = ((payload[slot] != EMPTY) & (tk1[slot] == k1[pending])
                   & (tk2[slot] == k2[pending]))
        pending = pending[~present]
    return tk1[:m], tk2[:m], payload[:m], pending.numel() == 0


def probe_table_plain(tk1: torch.Tensor, tk2: torch.Tensor, payload: torch.Tensor,
                      q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the Pallas body's 16 vectorized rounds. The
    first matching slot wins; the first vacant slot ends the search."""
    m = tk1.shape[0]
    h = _mix(q1, q2)
    out = torch.full(q1.shape, EMPTY, dtype=torch.int32, device=q1.device)
    done = torch.zeros(q1.shape, dtype=torch.bool, device=q1.device)
    for i in range(MAX_PROBE):
        slot = (h + i) & (m - 1)
        p = payload[slot]
        vacant = p == EMPTY
        match = ~vacant & (tk1[slot] == q1) & (tk2[slot] == q2)
        out = torch.where(match & ~done, p, out)
        done |= match | vacant
    return out


def slot_tensor(tk1: torch.Tensor, tk2: torch.Tensor, payload: torch.Tensor):
    """The ``int32[m, 4]`` slot tensor whose columns 0, 1 and 2 are these
    stride-4 views (a 16 B-aligned base, as ``build_table`` makes), or None."""
    m = tk1.shape[0]
    if not tk1.stride() == tk2.stride() == payload.stride() == (4,):
        return None
    p = tk1.data_ptr()
    if p % 16 or tk2.data_ptr() != p + 4 or payload.data_ptr() != p + 8:
        return None
    if tk1.untyped_storage().nbytes() < (tk1.storage_offset() + 4 * m) * 4:
        return None  # no padding word after the last slot's payload
    return torch.as_strided(tk1, (m, 4), (4, 1), tk1.storage_offset())


def _check(tk1, tk2, payload, q1, q2):
    """Raise on what the kernel does not take; return the slot tensor when
    the table is in the slot layout, None when it is three contiguous
    arrays."""
    dev = q1.device
    for name, t in (("tk1", tk1), ("tk2", tk2), ("payload", payload),
                    ("q1", q1), ("q2", q2)):
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {name} on "
                             f"{t.device}, q1 on {dev}")
        if t.dtype != torch.int32 or t.ndim != 1:
            raise TypeError(f"{name} must be int32[n], got {t.dtype}{list(t.shape)}")
    for name, t in (("q1", q1), ("q2", q2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m = tk1.shape[0]
    if tk2.shape[0] != m or payload.shape[0] != m:
        raise ValueError("tk1, tk2 and payload must have one length")
    if m < 1 or m & (m - 1) or m > (1 << 31):
        raise ValueError(f"table size must be a power of two <= 2^31, got {m}")
    if q2.shape != q1.shape:
        raise ValueError("q1 and q2 must have one length")
    if tk1.is_contiguous() and tk2.is_contiguous() and payload.is_contiguous():
        return None
    slots = slot_tensor(tk1, tk2, payload)
    if slots is None:
        raise ValueError("tk1, tk2 and payload must be contiguous arrays or columns "
                         "0, 1 and 2 of one 16 B-aligned int32[m, 4] slot tensor")
    return slots


def probe_table(tk1: torch.Tensor, tk2: torch.Tensor, payload: torch.Tensor,
                q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Look up each query (q1[i], q2[i]); int32 build row id or EMPTY."""
    slots = _check(tk1, tk2, payload, q1, q2)
    if q1.device.type == "cpu":
        return probe_table_plain(tk1, tk2, payload, q1, q2)
    if q1.device.type != "cuda":
        raise ValueError(f"no kernel for device {q1.device}")
    n = q1.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=q1.device)
    if n == 0:
        return out
    if slots is None:  # separate arrays: one layout copy into slots
        slots = torch.stack([tk1, tk2, payload, torch.zeros_like(tk1)], 1)
        probe_table.packs += 1
    fn = load_library("hashtable_probe").hashtable_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(slots.data_ptr(), q1.data_ptr(), q2.data_ptr(), out.data_ptr(), n,
                 tk1.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"hashtable_probe launch failed: CUDA error {err}")
    probe_table.launches += 1
    return out


probe_table.launches = 0  # kernel launches; chip_smoke.py reads it
probe_table.packs = 0     # layout copies of separate arrays into slots
