"""Linear-probing hash table for distinct-key build sides (counterpart of
``cudf_tpu/kernels/hashtable.py``; the cuco::static_set of libcudf's
distinct_hash_join.cu).

Contents as in the reference: open addressing over a power-of-two number
of slots, two 32-bit key words and an int32 payload per slot, ``EMPTY``
(INT32_MIN) marking a vacant slot. Layout: one 16 B slot, ``int32[m+1, 4]``
rows of (tk1, tk2, payload, 0), so the probe kernel reads a slot with one
vector load; ``build_table`` and ``insert_table`` hand out its columns 0-2
as views. torch has no unsigned 32-bit arithmetic on the CPU, so key words
are int32 tensors holding the u32 bit pattern; the hash ``_mix`` runs in
int64 and masks to 32 bits after every multiply (int64 multiplication
wraps, and its low 32 bits are the u32 product), so it equals the
reference's u32 ``_mix`` bit for bit.

* ``build_table`` — plain PyTorch: rounds of ``scatter_reduce_("amin")``,
  in which every unplaced row bids its row id for slot ``(h + i) & (m-1)``;
  the smallest bid wins a vacant slot, so a duplicate key keeps its
  smallest row id. The rounds stop once every row is placed (a placed row
  never wins again, so the remaining rounds of the reference change
  nothing), and give up after ``MAX_PROBE``, the reference's bound.
* ``insert_table`` — the build with no probe cap, which never fails at
  ``table_size_for``'s load: on a CUDA tensor one launch of the
  hand-written insert kernel (``csrc/hashtable_probe.cu``), on a CPU
  tensor ``insert_table_plain``, the same rounds as ``build_table`` run
  until every row is placed. It returns the slots claimed (the distinct
  active keys) and the longest displacement, which bounds the probe.
  Where a key lands depends on the kernel's schedule; each key is in the
  table once, with its smallest valid row id.
* ``probe_table`` — on a CUDA tensor the hand-written kernel
  (``csrc/hashtable_probe.cu``) over the slot tensor: the views'
  base where the table is in the slot layout, else the three arrays packed
  into one once; on a CPU tensor ``probe_table_plain``, the Pallas body's
  vectorized probe rounds. Both look at ``max_probe`` slots at most,
  ``MAX_PROBE`` unless the caller knows its table's longest displacement.
"""
from __future__ import annotations

import torch

from ..utils.tracing import annotate
from . import KernelError, entry, on_device, stream_of

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


def _rounds(k1, k2, valid, m: int, rounds: int):
    """``build_table``'s rounds, at most ``rounds`` of them: (the
    ``int32[m+1, 4]`` slots, the rows left unplaced, the last round that
    ran)."""
    if m & (m - 1) or m < 1:
        raise ValueError(f"table size must be a power of two, got {m}")
    dev = k1.device
    h = _mix(k1, k2)
    slots = torch.zeros((m + 1, 4), dtype=torch.int32, device=dev)
    slots[:, 2] = EMPTY
    tk1, tk2, payload = slots[:, 0], slots[:, 1], slots[:, 2]
    with annotate("host_read.hashtable.pending"):
        pending = torch.nonzero(valid).squeeze(1)  # unplaced row ids, ascending
    last = 0
    for i in range(rounds):
        if pending.numel() == 0:
            break
        last = i
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
        with annotate("host_read.hashtable.pending"):
            pending = pending[~present]
    return slots, pending, last


def build_table(k1: torch.Tensor, k2: torch.Tensor, valid: torch.Tensor, m: int):
    """Insert rows (k1[i], k2[i]) -> i for valid rows into m slots.

    Returns (tk1, tk2, payload, all_placed): int32[m] each, columns 0-2 of
    one 16 B-aligned ``int32[m+1, 4]`` slot tensor whose column 3 is 0, and
    a bool; ``all_placed`` is False when some row found no slot in
    MAX_PROBE probes. Slot m is the overflow slot of the reference's
    ``mode="drop"`` scatter; it is sliced off."""
    slots, pending, _ = _rounds(k1, k2, valid, m, MAX_PROBE)
    return slots[:m, 0], slots[:m, 1], slots[:m, 2], pending.numel() == 0


def insert_table_plain(k1: torch.Tensor, k2: torch.Tensor, valid: torch.Tensor, m: int):
    """Plain PyTorch version of the insert kernel: ``build_table``'s rounds
    with no cap of MAX_PROBE. Returns (tk1, tk2, payload, occupied,
    longest) as ``insert_table`` does; raises ValueError when a row finds
    no slot in all m."""
    slots, pending, longest = _rounds(k1, k2, valid, m, m)
    if pending.numel():
        raise ValueError(f"{pending.numel()} rows found no slot in {m}: the table is "
                         f"smaller than the distinct active keys")
    payload = slots[:m, 2]
    return (slots[:m, 0], slots[:m, 1], payload, int((payload != EMPTY).sum().item()),
            longest)


def insert_table(k1: torch.Tensor, k2: torch.Tensor, valid: torch.Tensor, m: int):
    """Insert rows (k1[i], k2[i]) -> i for valid rows into m slots, with
    no probe cap: one kernel launch on a CUDA tensor, the plain version
    on a CPU tensor.

    Returns (tk1, tk2, payload, occupied, longest): columns 0-2 of one
    16 B-aligned ``int32[m+1, 4]`` slot tensor whose column 3 is 0, as
    ``build_table`` hands them out; the slots claimed, which is the number
    of distinct active keys; and the longest displacement of a key from
    its home slot, so that ``probe_table(..., max_probe=longest + 1)``
    finds every key. Each key holds its smallest valid row id. Raises
    ValueError when a row finds no slot in all m (more distinct keys than
    slots)."""
    for name, t in (("k1", k1), ("k2", k2), ("valid", valid)):
        if t.device != k1.device:
            raise ValueError(f"tensors on different devices: {name} on {t.device}, "
                             f"k1 on {k1.device}")
        if t.ndim != 1 or t.shape != k1.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor of k1's length")
    if k1.dtype != torch.int32 or k2.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("k1 and k2 must be int32, valid bool")
    if m < 1 or m & (m - 1) or m > (1 << 30):
        raise ValueError(f"table size must be a power of two <= 2^30, got {m}")
    n = k1.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: row ids must fit int32")
    if k1.device.type == "cpu":
        out = insert_table_plain(k1, k2, valid, m)
    elif k1.device.type == "cuda":
        slots = torch.empty((m + 1, 4), dtype=torch.int32, device=k1.device)
        counts = torch.empty(2, dtype=torch.int32, device=k1.device)
        fn = entry("hashtable_probe", "hashtable_insert")
        with on_device(k1.device):
            err = fn(slots.data_ptr(), k1.data_ptr(), k2.data_ptr(), valid.data_ptr(), n, m,
                     counts.data_ptr(), stream_of(k1.device))
        if err != 0:
            raise KernelError(f"hashtable_insert launch failed: CUDA error {err}")
        insert_table.launches += 1
        with annotate("host_read.hashtable.counts"):
            occupied, longest = counts.tolist()
        if longest >= m:
            raise ValueError(f"a row found no slot in {m}: the table is smaller than "
                             f"the distinct active keys")
        out = slots[:m, 0], slots[:m, 1], slots[:m, 2], occupied, longest
    else:
        raise ValueError(f"no kernel for device {k1.device}")
    if out[4] >= MAX_PROBE:
        insert_table.past_max_probe += 1
    return out


insert_table.launches = 0        # kernel launches; chip_smoke.py reads it
insert_table.past_max_probe = 0  # builds that MAX_PROBE rounds would have left unplaced


def probe_table_plain(tk1: torch.Tensor, tk2: torch.Tensor, payload: torch.Tensor,
                      q1: torch.Tensor, q2: torch.Tensor,
                      max_probe: int = MAX_PROBE) -> torch.Tensor:
    """Plain PyTorch version: the Pallas body's vectorized rounds, one a
    slot looked at. The first matching slot wins; the first vacant slot
    ends the search."""
    m = tk1.shape[0]
    h = _mix(q1, q2)
    out = torch.full(q1.shape, EMPTY, dtype=torch.int32, device=q1.device)
    done = torch.zeros(q1.shape, dtype=torch.bool, device=q1.device)
    for i in range(max_probe):
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


def _check(tk1, tk2, payload, q1, q2, max_probe=MAX_PROBE):
    """Raise on what the kernel does not take; return the slot tensor when
    the table is in the slot layout, None when it is three contiguous
    arrays."""
    if not isinstance(max_probe, int) or not 1 <= max_probe < (1 << 31):
        raise ValueError(f"max_probe must be an int >= 1, got {max_probe!r}")
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
                q1: torch.Tensor, q2: torch.Tensor, max_probe: int = MAX_PROBE) -> torch.Tensor:
    """Look up each query (q1[i], q2[i]) in at most ``max_probe`` slots
    from its home; int32 build row id or EMPTY."""
    slots = _check(tk1, tk2, payload, q1, q2, max_probe)
    if q1.device.type == "cpu":
        return probe_table_plain(tk1, tk2, payload, q1, q2, max_probe)
    if q1.device.type != "cuda":
        raise ValueError(f"no kernel for device {q1.device}")
    n = q1.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=q1.device)
    if n == 0:
        return out
    if slots is None:  # separate arrays: one layout copy into slots
        slots = torch.stack([tk1, tk2, payload, torch.zeros_like(tk1)], 1)
        probe_table.packs += 1
    fn = entry("hashtable_probe", "hashtable_probe")
    with on_device(q1.device):
        err = fn(slots.data_ptr(), q1.data_ptr(), q2.data_ptr(), out.data_ptr(), n,
                 tk1.shape[0], max_probe, stream_of(q1.device))
    if err != 0:
        raise KernelError(f"hashtable_probe launch failed: CUDA error {err}")
    probe_table.launches += 1
    return out


probe_table.launches = 0  # kernel launches; chip_smoke.py reads it
probe_table.packs = 0     # layout copies of separate arrays into slots
