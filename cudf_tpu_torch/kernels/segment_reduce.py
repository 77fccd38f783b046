"""Per-segment reduction over non-decreasing segment ids (no counterpart in
``cudf_tpu/kernels/``: the reference's ``sortprim`` reduces segments with
XLA's ``segment_sum``/``segment_min``/``segment_max``, which need no
kernel of their own).

``segment_reduce(vals, seg, num_segments, reduce, init)`` returns, for each
segment s, ``init`` combined with the ``reduce`` (``"sum"``, ``"prod"``,
``"amin"``, ``"amax"``) of the values whose id is s: ``init`` takes part in
every segment and is the value of an empty one. The ids are int64,
non-decreasing and in [0, num_segments): every groupby lane reduces
key-sorted rows, its padding sent to an overflow segment at the end.

On a CUDA tensor it launches the hand-written kernel
(``csrc/segment_reduce.cu``): a reduce-by-key over tiles of 4096 rows with
no atomics, whose float sums take a fixed order (the same bits on every
run; the error bound is in the source). It was added because torch's
``scatter_reduce_`` takes one atomic a row, and sorted ids send runs of
rows to one address. On a CPU tensor it checks that the ids do not
decrease and runs ``segment_reduce_plain``, which is that
``scatter_reduce_`` and the kernel's oracle: it folds each segment's rows
in row order, so a term of a segment of m rows goes through at most
m - 1 additions and a float sum is within (m - 1)·eps·Σ_segment|x|.

Every groupby lane's per-group sums and counts are this function's sums,
and hold its two promises on either device: a segment combines only its
own rows (a NaN or a large running total in one group reaches no other),
and a float sum takes one fixed order, the same bits on every run.

The kernel does not stop at ids that break the contract (its results are
then wrong): it sets a flag, which ``contract_broken()`` reads, so that
the card's tests and ``chip_smoke.py`` prove the contract for the calls
they make without a synchronize on the engine's path. The flag is one
int32 of pinned host memory, which the kernel writes through the unified
address space: it holds no device memory.

Only the (reduction, dtype) pairs in ``SERVED`` are built: those the
callers pass.
"""
from __future__ import annotations

import torch

from . import KernelError, entry, on_device, stream_of

REDUCES = {"sum": 0, "prod": 1, "amin": 2, "amax": 3}
# the kernel's value types, by its dtype code
DTYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4,
          torch.float32: 5, torch.float64: 6, torch.bfloat16: 7}
# the dtypes each reduction is built for: what the callers pass (sums of
# counts and of float accumulators, products in the int64 or float64
# accumulator, min and max of any column through fastgroup._reducible)
SERVED = {"sum": (torch.int64, torch.float32, torch.float64),
          "prod": (torch.int64, torch.float64), "amin": tuple(DTYPES), "amax": tuple(DTYPES)}
_FLAG = []  # one pinned int32, set by any launch whose ids broke the contract


def segment_reduce_plain(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
                         reduce: str, init) -> torch.Tensor:
    """Plain PyTorch version: ``scatter_reduce_`` into an ``init``-filled
    output, ``init`` included."""
    out = torch.full((num_segments,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, reduce, include_self=True)


def _check(vals, seg, reduce):
    if vals.device != seg.device:
        raise ValueError(f"tensors on different devices: {vals.device}, {seg.device}")
    if seg.dtype != torch.int64 or seg.ndim != 1:
        raise TypeError(f"seg must be int64[n], got {seg.dtype}{list(seg.shape)}")
    if vals.dtype not in DTYPES:
        raise TypeError(f"no segment reduction of {vals.dtype}")
    if vals.shape != seg.shape:
        raise TypeError(f"vals must be [{seg.shape[0]}], got {list(vals.shape)}")
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduction {reduce!r}")
    if vals.dtype not in SERVED[reduce]:
        raise TypeError(f"no segment {reduce} of {vals.dtype}")


def _flag() -> torch.Tensor:
    if not _FLAG:
        _FLAG.append(torch.zeros(1, dtype=torch.int32, pin_memory=True))
    return _FLAG[0]


def contract_broken() -> bool:
    """Whether a launch since the last call, on any card, saw ids that
    decrease or leave [0, num_segments). Waits for every card, reads the
    flag and clears it."""
    if not _FLAG:
        return False
    for index in range(torch.cuda.device_count()):
        torch.cuda.synchronize(index)
    broken = bool(_FLAG[0][0])
    _FLAG[0].zero_()
    return broken


def segment_reduce(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   reduce: str, init) -> torch.Tensor:
    """[num_segments] of ``vals``' dtype: ``init`` combined with each
    segment's ``reduce``. ``seg`` int64[n], non-decreasing."""
    _check(vals, seg, reduce)
    dev = seg.device
    if dev.type == "cpu":
        if seg.numel() > 1 and bool((seg[1:] < seg[:-1]).any()):
            raise ValueError("segment ids must be non-decreasing")
        return segment_reduce_plain(vals, seg, num_segments, reduce, init)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.full((num_segments,), init, dtype=vals.dtype, device=dev)
    n = seg.numel()
    if n == 0:
        return out
    seg, vals = seg.contiguous(), vals.contiguous()
    slots = entry("segment_reduce", "segment_reduce_scratch")(n)
    carry_id = torch.empty(slots, dtype=torch.int64, device=dev)
    carry_val = torch.empty(slots, dtype=vals.dtype, device=dev)
    init_t = torch.full((1,), init, dtype=vals.dtype)  # its bits, on the host
    fn = entry("segment_reduce", "segment_reduce")
    with on_device(dev):
        err = fn(seg.data_ptr(), vals.data_ptr(), n, num_segments, DTYPES[vals.dtype],
                 REDUCES[reduce], init_t.data_ptr(), out.data_ptr(), carry_id.data_ptr(),
                 carry_val.data_ptr(), _flag().data_ptr(), stream_of(dev))
    if err != 0:
        raise KernelError(f"segment_reduce launch failed: CUDA error {err}")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0  # calls that launched the kernel; chip_smoke.py reads it
