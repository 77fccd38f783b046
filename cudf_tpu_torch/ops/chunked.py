"""Chunked execution of sort, groupby and compaction past the memory an op
may use (counterpart of ``cudf_tpu/ops/chunked.py``).

The reference chunks past a 16M-row envelope and an operand-element budget,
both set by its TPU compile helper. Here an op chunks when its estimated
device working set (its input's bytes times a factor for the op's
temporaries) exceeds the memory it may use (``memory_limit``):

  * the installed ``utils.hbm`` budget's ``budget``, on any device;
  * otherwise, on a CUDA table, ``DEVICE_SHARE`` of what the caching
    allocator can still hand out (the card's free memory plus the blocks
    the allocator holds unused), asked only of an op whose working set
    passes ``QUERY_SHARE`` of the card's memory;
  * otherwise, on a CPU table, ``CPU_LIMIT_BYTES`` (None: never).

The chunked branches give the unchunked answers:

  * sort: ``sample_sort`` over contiguous chunks. Splitter tuples sampled
    from each chunk's order operands (``sorting._order_operands``) put
    every row in a bucket (below, equal to or above each splitter); a
    bucket is gathered from the input when its turn comes, and one between
    two splitters is sorted, stably. The output is the unchunked
    permutation exactly, NaN, -0 and nulls included, since the operands
    are the unchunked sort's own;
  * groupby: a partial aggregate per chunk, merged and finalized
    (``ops/streaming_groupby.py``); the same groups, counts and order,
    float aggregates summed in another order;
  * compaction: the kept rows of each chunk written at their offset into
    one output, so the rows are the unchunked compaction's exactly.

Each branch counts its runs in ``runs`` (a test and ``chip_smoke.py`` read
them).
"""
from __future__ import annotations

import functools
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.column import Column
from ..core.table import Table
from ..utils.hbm import table_device_bytes
from ..utils.padding import bucket_capacity

# Working set = input bytes x factor. Sort: the key operands (int64 each),
# the permutation and torch.sort's value/index buffers, and the gathered
# output: about four times a table of a few 4-8 byte columns. Groupby: the
# key codes, permutation, segment ids and per-group sums, about the same.
# Compaction: the output (at most the input) and the kept rows' int64
# positions.
SORT_FACTOR = 4
GROUPBY_FACTOR = 4
COMPACT_FACTOR = 2
# Half of what the allocator can hand out: the estimate is rough, and the
# caching allocator rounds and fragments blocks.
DEVICE_SHARE = 0.5
# Without a budget, an op whose working set is under an eighth of the card
# never chunks and does not ask the card what is free: asking
# (torch.cuda.mem_get_info) took 74-567 us a call on an NVIDIA H100 80GB
# HBM3 in two runs of chip_smoke.py's out-of-core phase, more than many
# whole ops.
QUERY_SHARE = 1 / 8
CPU_LIMIT_BYTES: Optional[int] = None
MIN_CHUNK_ROWS = 1 << 12
SAMPLES_PER_CHUNK = 256

runs = {"sort": 0, "groupby": 0, "compaction": 0}


@functools.lru_cache(maxsize=None)
def _card_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).total_memory


def memory_limit(device: torch.device, need: int) -> Optional[int]:
    """Bytes an op on ``device`` may use, or None for no limit. ``need`` is
    the op's working set: the card is asked what is free only when ``need``
    passes QUERY_SHARE of it, and the allocator's statistics only when the
    free memory alone would not cover it."""
    from ..utils.hbm import get_hbm_budget

    budget = get_hbm_budget()
    if budget is not None:
        return budget.budget
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        if need <= _card_bytes(index) * QUERY_SHARE:
            return None
        free, _ = torch.cuda.mem_get_info(device)
        if need <= free * DEVICE_SHARE:
            return int(free * DEVICE_SHARE)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int((free + cached) * DEVICE_SHARE)
    return CPU_LIMIT_BYTES


def chunk_rows(tbl: Table, factor: int) -> Optional[int]:
    """Rows a chunk when ``tbl``'s op must chunk, else None: a power of two
    whose chunk's working set fits the limit, at least MIN_CHUNK_ROWS."""
    if tbl.num_columns == 0 or tbl.num_rows <= MIN_CHUNK_ROWS:
        return None
    need = table_device_bytes(tbl) * factor
    limit = memory_limit(tbl.device, need)
    if limit is None or need <= limit:
        return None
    per_row = need / tbl.columns[0].capacity
    rows = 1 << max(int(limit // per_row).bit_length() - 1, 0)
    return max(rows, MIN_CHUNK_ROWS)


# ---------------------------------------------------------------------------
# lexicographic order over operand tuples (shared with the partitioned sort)
# ---------------------------------------------------------------------------

def sample_rows(ops: Sequence[torch.Tensor], n: int, k: int = SAMPLES_PER_CHUNK) -> np.ndarray:
    """int64[min(k, n), len(ops)]: the operand tuples of ``k`` evenly spaced
    rows among the first ``n``."""
    if n == 0:
        return np.zeros((0, len(ops)), np.int64)
    pos = (torch.arange(min(k, n), device=ops[0].device) * n) // min(k, n)
    return torch.stack([op[pos] for op in ops], 1).cpu().numpy()


def splitters(samples: Sequence[np.ndarray], n_buckets: int) -> np.ndarray:
    """Up to ``n_buckets - 1`` distinct splitter tuples, in ascending order,
    at the quantiles of the samples."""
    s = np.concatenate(samples)
    if len(s) == 0 or n_buckets <= 1:
        return s[:0]
    s = s[np.lexsort(s.T[::-1])]
    q = (np.arange(1, n_buckets) * len(s)) // n_buckets
    picked = s[q]
    keep = np.ones(len(picked), bool)
    keep[1:] = (picked[1:] != picked[:-1]).any(1)
    return picked[keep]


def lex_below_equal(ops: Sequence[torch.Tensor], split: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row < split, row == split) for every row, comparing operand tuples
    lexicographically, earlier operands more significant."""
    lt = torch.zeros(ops[0].shape, dtype=torch.bool, device=ops[0].device)
    eq = torch.ones_like(lt)
    for op, s in zip(ops, split.tolist()):
        lt |= eq & (op < s)
        eq &= op == s
    return lt, eq


def bucket_ids(ops: Sequence[torch.Tensor], splits: np.ndarray) -> torch.Tensor:
    """int64 bucket of every row among the 2k + 1 of k splitters: 2j for the
    rows between splitters j - 1 and j, 2j + 1 for the rows equal to
    splitter j. Buckets in id order are in sort order."""
    below = torch.zeros(ops[0].shape, dtype=torch.int64, device=ops[0].device)
    equal = torch.zeros(ops[0].shape, dtype=torch.bool, device=ops[0].device)
    for s in splits:
        lt, eq = lex_below_equal(ops, s)
        below += ~(lt | eq)
        equal |= eq
    return 2 * below + equal


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def _padded(idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(bucket_capacity(n), dtype=torch.int64, device=idx.device)
    out[:n] = idx
    return out


def sample_sort(count: int, source: Callable[[int], Table], keys: Sequence[str], desc, nl,
                n_buckets: int, hold: Callable[[int, Table, torch.Tensor], object],
                fetch: Callable[[List[object]], Table]) -> Iterator[Table]:
    """The rows of ``count`` tables, concatenated and sorted by ``keys``,
    one bucket at a time in output order (the sample sort that the chunked
    ``sort_by_key`` and ``PartitionedFrame.sort_values`` share).

    ``source(i)`` is the i-th table on the device; every table's key
    columns must compare alike (one dictionary for a string key, a
    validity mask in all tables or none). Splitter tuples at the quantiles
    of each table's sampled order operands (``sorting._order_operands``:
    each key's flags, NaN, -0 and null placement included) split the rows
    into up to ``n_buckets`` ranges and the rows equal to each splitter.
    ``hold(i, t, rows)`` keeps the rows ``rows`` (int64 positions, in
    order) of a bucket in ``t = source(i)`` and returns a handle;
    ``fetch(handles)`` gives the held rows of one bucket, source by
    source, as one table. A bucket of rows equal to a splitter is then in
    source-major (original) order, which is its sorted order; a bucket
    between two splitters is sorted, stably. The output is the
    concatenation's ``sort_by_key`` exactly."""
    from .copying import gather_table
    from .sorting import _order_operands
    from .sortprim import multisort_perm

    def operands(t):
        return [op[:t.num_rows] for op in _order_operands([t[k] for k in keys], desc, nl)]

    samples = []
    for i in range(count):
        t = source(i)
        samples.append(sample_rows(operands(t), t.num_rows))
        del t
    splits = splitters(samples, n_buckets)
    held: List[List[object]] = [[] for _ in range(2 * len(splits) + 1)]
    for i in range(count):
        t = source(i)
        bucket = bucket_ids(operands(t), splits)
        order = torch.sort(bucket, stable=True).indices
        counts = torch.bincount(bucket, minlength=len(held)).cpu().tolist()
        at = 0
        for b, cnt in enumerate(counts):
            if cnt:
                held[b].append(hold(i, t, order[at:at + cnt]))
            at += cnt
        del t, bucket, order
    for b in range(len(held)):
        handles, held[b] = held[b], []
        if not handles:
            continue
        part = fetch(handles)
        del handles
        if b % 2 == 0 and part.num_rows > 1:
            perm = multisort_perm(_order_operands([part[k] for k in keys], desc, nl))
            part = gather_table(part, perm, part.num_rows)
        yield part


def _write_rows(out: dict, at: int, part: Table) -> None:
    n = part.num_rows
    for name, c in part:
        data, validity = out[name]
        data[at:at + n] = c.data[:n]
        if validity is not None:
            validity[at:at + n] = c.validity[:n]


def _empty_like(tbl: Table, n: int) -> dict:
    cap = bucket_capacity(n)
    return {name: (torch.zeros(cap, dtype=c.data.dtype, device=c.device),
                   None if c.validity is None else
                   torch.zeros(cap, dtype=torch.bool, device=c.device))
            for name, c in tbl}


def _table_from(tbl: Table, out: dict, n: int) -> Table:
    return Table({name: Column(c.dtype, out[name][0], out[name][1], n, c.dictionary)
                  for name, c in tbl})


def chunked_sort_by_key(tbl: Table, keys: Sequence[str], desc, nl, rows: int) -> Table:
    """``sort_by_key`` as a sample sort over chunks of ``rows`` rows (see
    the module doc). A bucket is held as the int32 positions of its rows in
    ``tbl`` and gathered from ``tbl`` when its turn comes, so beside the
    input and the output the device holds four bytes a row and one
    bucket's sort."""
    from .copying import gather_table

    runs["sort"] += 1
    n = tbl.num_rows
    starts = list(range(0, n, rows))

    def fetch(handles):
        idx = torch.cat(handles) if len(handles) > 1 else handles[0]
        return gather_table(tbl, _padded(idx, idx.numel()), idx.numel())

    out = _empty_like(tbl, n)
    at = 0
    for part in sample_sort(len(starts), lambda i: tbl.slice(starts[i], rows), keys, desc,
                            nl, 2 * len(starts),
                            lambda i, t, idx: (idx + starts[i]).to(torch.int32), fetch):
        _write_rows(out, at, part)
        at += part.num_rows
    return _table_from(tbl, out, n)


# ---------------------------------------------------------------------------
# groupby
# ---------------------------------------------------------------------------

def chunked_groupby(tbl: Table, keys: Sequence[str], aggs, dropna_keys: bool,
                    rows: int) -> Optional[Table]:
    """Partial aggregates over chunks of ``rows`` rows, merged and
    finalized; None when an aggregation does not merge."""
    from . import streaming_groupby as sg

    if not all(a.kind in sg.SUPPORTED for a in aggs):
        return None
    runs["groupby"] += 1
    parts = (tbl.slice(start, rows) for start in range(0, tbl.num_rows, rows))
    return sg.streaming_groupby(parts, keys, aggs, dropna_keys)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def chunked_compact(tbl: Table, keep: torch.Tensor, rows: int) -> Table:
    """Rows of ``tbl`` where ``keep``, the positions found ``rows`` at a
    time and each chunk's rows gathered into one output."""
    from .stream_compaction import carry_stats

    runs["compaction"] += 1
    n_out = int(keep[:tbl.num_rows].sum().item())
    out = _empty_like(tbl, n_out)
    at = 0
    for start in range(0, tbl.num_rows, rows):
        idx = torch.nonzero(keep[start:start + rows]).squeeze(1) + start
        m = idx.numel()
        for name, c in tbl:
            data, validity = out[name]
            data[at:at + m] = c.data[idx]
            if validity is not None:
                validity[at:at + m] = c.validity[idx]
        at += m
    result = _table_from(tbl, out, n_out)
    for name, c in tbl:
        carry_stats(c, result[name])
    return result
