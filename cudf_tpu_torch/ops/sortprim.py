"""Sort primitive and scans (counterpart of ``cudf_tpu/ops/sortprim.py``).

The reference packs u32 operands into u64 words and sorts them with
``lax.sort``, embedding the row id in the key for stability. Here every
operand is an int64 order code (``ops/rowcodes.py``: signed order is the
wanted order) and ``multisort_perm`` is a chain of stable ``torch.sort``
passes, least significant operand first, which yields the same stable
lexicographic permutation.

The reference's tiled scans exist to bound TPU compile time; the
counterparts here are flat torch scans. The groupby lanes read a segmented
scan only at a group's end row, which is the per-group reduction, so they
call ``segment_reduce``; ``segmented_scan`` gives every row's inclusive
value for any associative ``combine``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import segment_reduce as _segment_kernel
from ..utils.tracing import annotate


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


def lsd_payload_sort(words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Stable lexicographic sort by words (most significant first) carrying
    payloads: (sorted words, each sorted row's original index, sorted
    payloads). The reference runs one flat sort a word, least significant
    first, each stable by a position tiebreak; here ``multisort_perm``'s
    stable passes give that permutation, and one gather a tensor applies
    it. Words are int64 (the order words of ``sorting.build_order_words``
    hold u64 bits with the top bit flipped, so signed order is theirs)."""
    perm = multisort_perm(list(words))
    return [w[perm] for w in words], perm, [p[perm] for p in payloads]


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
    segment and takes part in every segment. Ids must be non-decreasing
    and lie in [0, num_segments): callers reduce key-sorted rows and send
    padding to an overflow segment at the end. A CUDA tensor takes the
    reduce-by-key kernel (``kernels/segment_reduce.py``), which does not
    stop at ids out of order: its answer is then wrong, and it only sets
    the flag that ``kernels.segment_reduce.contract_broken()`` reads. On
    the CPU the ids' order is checked, and decreasing ids raise. One
    ``segment_reduce`` range a call."""
    with annotate("segment_reduce"):
        return _segment_kernel.segment_reduce(vals, seg, num_segments, reduce, init)


def segmented_scan(vals: torch.Tensor, newseg: torch.Tensor, combine) -> torch.Tensor:
    """Inclusive segmented scan: restarts at rows where ``newseg`` is True.

    ``combine(a, b)`` is any associative elementwise tensor function
    (``torch.add``, ``torch.minimum``, ``torch.maximum``, ``torch.mul``,
    "keep first" ``lambda a, b: a``). The (flag, value) pair semigroup
    ``(fa, va) . (fb, vb) = (fa | fb, vb if fb else combine(va, vb))`` is
    associative, so a log-step (Hillis-Steele) scan over the pairs does it
    in ceil(log2 n) steps."""
    v, f = vals.clone(), newseg.to(torch.bool).clone()
    n, d = v.shape[0], 1
    while d < n:
        nv = torch.where(f[d:], v[d:], combine(v[:-d], v[d:]))
        f[d:] = f[d:] | f[:-d]
        v[d:] = nv
        d *= 2
    return v
