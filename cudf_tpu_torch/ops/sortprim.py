"""Sort primitive and scans (counterpart of ``cudf_tpu/ops/sortprim.py``).

The reference packs u32 operands into u64 words and sorts them with
``lax.sort``, embedding the row id in the key for stability. Here every
operand is an int64 order code (``ops/rowcodes.py``: signed order is the
wanted order) and ``multisort_perm`` is a chain of stable ``torch.sort``
passes, least significant operand first, which yields the same stable
lexicographic permutation.

The reference's tiled scans exist to bound TPU compile time; the
counterparts here are flat torch scans. ``segmented_scan`` becomes
``segment_reduce``: every caller reads a segmented scan only at the group's
end row, which is the per-group reduction.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _posbits(cap: int) -> int:
    return max(1, (cap - 1).bit_length())


def multisort_perm(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic permutation (int64) over int64 operands,
    earlier operands more significant."""
    ops = list(operands)
    cap = ops[0].shape[0]
    perm = torch.arange(cap, dtype=torch.int64, device=ops[0].device)
    for op in reversed(ops):
        order = torch.sort(op[perm], stable=True).indices
        perm = perm[order]
    return perm


def tiled_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum (bool and integer inputs sum in int64)."""
    return torch.cumsum(x, 0)


def tiled_cumprod(x: torch.Tensor) -> torch.Tensor:
    return torch.cumprod(x, 0)


def tiled_cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def tiled_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x, 0).values


def segment_reduce(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   reduce: str, init) -> torch.Tensor:
    """Per-segment reduction (``"sum"``, ``"prod"``, ``"amin"``, ``"amax"``)
    of ``vals`` by int64 segment id; ``init`` is the value of an empty
    segment and takes part in every segment. Ids must lie in
    [0, num_segments): callers send padding to an overflow segment."""
    out = torch.full((num_segments,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, reduce, include_self=True)
