"""Equi-joins: inner/left/right/semi/anti/full, plus cross join
(counterpart of ``cudf_tpu/ops/join.py``; libcudf's cpp/src/join/).

Dispatch, in order:

  0. the swap: an inner join with ``ordered=False`` whose right side has
     more active rows than its left tries the hash-table lane with the
     LEFT side as the build side (``try_fast_join(..., build_left=True)``;
     libcudf's join.cu builds on the smaller table, the reference swaps
     at its join.py:1217-1242); its rows come in right-row order, its
     columns as in the unswapped join. When that lane refuses, 1 follows;
  1. ``fastjoin.try_fast_join`` — the hash-table lane with the probe
     kernel, for inner/left joins whose build (right) side is distinct
     and for every semi/anti join, when the keys pack into 64 bits;
  2. the general lane: ONE stable sort of the concatenated (right ++ left)
     key operands with a side flag, rights before lefts within a key
     group (``_combined_codes`` + ``multisort_perm``); per-left-row match
     counts and right lower bounds fall out of prefix sums over the sorted
     rows (``_probe_finish``); one host read for the output size; then
     ``_expand`` builds the (left, right) gather maps. It handles any key
     width, duplicates on both sides and ``nulls_equal``.

Lanes 1 and 2 give rows in left-row order, and within one left row in
right-row order; ``ordered=False`` (libcudf's unordered contract) only
lets the swap run. The choice depends only on the data. Null keys match only under
``nulls_equal=True`` (cuDF null_equality); NaN equals NaN and -0 equals
+0 (cuDF nan_equality::ALL_EQUAL).

Not copied from the reference, which built them around TPU compile limits:
the word and sorted N:1 sort joins, the round-synchronous hash probe and
binary-search lanes, the probe-side chunking past its compile envelope,
the ``distinct_hint`` memo and the ``CUDF_TPU_SORTJOIN_PAYLOADS`` knob.
Their results are what both lanes here give.

``conditional_join`` joins on any row-pair predicate over blocks of left
rows crossed with the right table, and ``mixed_join`` is an equi-join on
this dispatch (so the probe kernel on a CUDA table) whose pairs a residual
predicate filters.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..utils.padding import bucket_capacity
from ..utils.tracing import annotate, trace_op
from . import rowcodes
from .copying import concatenate_tables, gather
from .sortprim import multisort_perm, tiled_cumsum
from .unaryop import cast

_HOWS = ("inner", "left", "right", "semi", "anti", "full")


def _promote_keys(left: Table, lk: Sequence[str], right: Table, rk: Sequence[str]):
    """Cast key pairs to a common dtype; unify string dictionaries and
    categories."""
    from ..core.categorical import is_categorical, unify_categoricals
    from .strings import unify_dictionaries

    lcols, rcols = [], []
    for ln, rn in zip(lk, rk):
        lc, rc = left[ln], right[rn]
        if is_categorical(lc) or is_categorical(rc):
            if not (is_categorical(lc) and is_categorical(rc)):
                raise TypeError(f"cannot join categorical key {ln!r} with {rn!r}: "
                                "categorical keys must be categorical on both sides")
            lc, rc = unify_categoricals([lc, rc])
        elif lc.dtype.is_string or rc.dtype.is_string:
            if not (lc.dtype.is_string and rc.dtype.is_string):
                raise TypeError(f"cannot join string key {ln!r} with {rn!r}")
            lc, rc = unify_dictionaries([lc, rc])
        elif lc.dtype != rc.dtype:
            common = dtypes.common_dtype(lc.dtype, rc.dtype)
            lc, rc = cast(lc, common), cast(rc, common)
        lcols.append(lc)
        rcols.append(rc)
    return lcols, rcols


def _join_key_operands(cols: Sequence[Column]) -> List[torch.Tensor]:
    """Equality operands with a null flag ALWAYS present (cross-side parity)."""
    ops: List[torch.Tensor] = []
    for c in cols:
        if c.validity is None:
            ops.append(torch.zeros(c.capacity, dtype=torch.int64, device=c.device))
        ops.extend(rowcodes.equality_operands(c))
    return ops


def _combined_codes(lcols, rcols) -> List[torch.Tensor]:
    """Operands for the combined (right ++ left) key sort: [oob, key
    operands..., side flag], padded to a power-of-two capacity. Equal keys
    group together, rights (flag 0) before lefts, padding last."""
    capL, capR = lcols[0].capacity, rcols[0].capacity
    dev = lcols[0].device
    total = capL + capR
    pad = bucket_capacity(total) - total

    def cat(r, l, fill):
        parts = [r, l]
        if pad:
            parts.append(torch.full((pad,), fill, dtype=torch.int64, device=dev))
        return torch.cat(parts)

    oob = cat((~rcols[0].bounds_mask()).to(torch.int64),
              (~lcols[0].bounds_mask()).to(torch.int64), 1)
    keys = [cat(r, l, 0) for r, l in zip(_join_key_operands(rcols),
                                         _join_key_operands(lcols))]
    flag = cat(torch.zeros(capR, dtype=torch.int64, device=dev),
               torch.ones(capL, dtype=torch.int64, device=dev), 1)
    return [oob] + keys + [flag]


def _anynull(cols, cap, dev) -> torch.Tensor:
    out = torch.zeros(cap, dtype=torch.bool, device=dev)
    for c in cols:
        if c.validity is not None:
            out |= ~c.validity
    return out


def _probe_finish(lcols, rcols, perm, nulls_equal: bool):
    """From the combined key-sorted permutation: per-left-row match counts
    and lower bounds, plus the key-ordered map of matchable right rows."""
    capL, capR = lcols[0].capacity, rcols[0].capacity
    dev = perm.device
    is_right = perm < capR
    is_left = (perm >= capR) & (perm < capR + capL)
    r_row = perm.clamp(0, capR - 1)
    l_row = (perm - capR).clamp(0, capL - 1)

    r_valid = is_right & (r_row < rcols[0].length)
    if not nulls_equal:
        r_valid &= ~_anynull(rcols, capR, dev)[r_row]

    # key-group boundaries over the combined sorted key operands
    key_sorted = [torch.where(is_right, r[r_row], l[l_row])
                  for r, l in zip(_join_key_operands(rcols), _join_key_operands(lcols))]
    newgrp = rowcodes.adjacent_neq(key_sorted)
    # each row's group start: the reference's cummax over start positions,
    # as a gather by group id (torch's cummax scan took 398 ms of a 557 ms
    # join at 2^27 combined rows on an H100)
    with annotate("host_read.join.group_start"):
        grp_start = torch.nonzero(newgrp).squeeze(1)[tiled_cumsum(newgrp) - 1]

    rv = r_valid.to(torch.int64)
    rights_incl = tiled_cumsum(rv)             # rights with key <= mine
    rights_excl = rights_incl - rv
    lb_here = rights_excl[grp_start]           # rights before my key group
    counts_sorted = rights_incl - lb_here

    # each left row appears once in perm: scatter to its original position
    with annotate("host_read.join.left_rows"):
        li = l_row[is_left]
    counts = torch.zeros(capL, dtype=torch.int64, device=dev)
    lb = torch.zeros(capL, dtype=torch.int64, device=dev)
    with annotate("host_read.join.left_rows"):
        counts[li] = counts_sorted[is_left]
    with annotate("host_read.join.left_rows"):
        lb[li] = lb_here[is_left]

    r_perm = torch.zeros(capR, dtype=torch.int64, device=dev)
    with annotate("host_read.join.right_rows"):
        r_perm[rights_excl[r_valid]] = r_row[r_valid]

    linb = lcols[0].bounds_mask()
    keep = linb if nulls_equal else linb & ~_anynull(lcols, capL, dev)
    return torch.where(keep, counts, 0), lb, r_perm, linb


def _probe(lcols, rcols, nulls_equal: bool):
    """Size pass of the general lane: (counts, lb, r_perm, linb)."""
    perm = multisort_perm(_combined_codes(lcols, rcols))
    return _probe_finish(lcols, rcols, perm, nulls_equal)


def _expand(counts, lb, r_perm, eff, n_out: int, out_cap: int):
    """Retrieve pass: (left_idx, right_idx) gather maps of out_cap rows.
    Left row i emits eff[i] rows (its match count, at least 1 for a left
    join's in-bounds rows); right_idx is -1 where a left row has no match
    and past n_out."""
    dev = counts.device
    src = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), eff,
                                  output_size=n_out)
    offs = tiled_cumsum(eff) - eff  # exclusive prefix over left rows
    pos_in = torch.arange(n_out, device=dev) - offs[src]
    r_sorted = (lb[src] + pos_in).clamp(0, r_perm.shape[0] - 1)
    left_idx = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    right_idx = torch.full((out_cap,), -1, dtype=torch.int64, device=dev)
    left_idx[:n_out] = src
    right_idx[:n_out] = torch.where(counts[src] > 0, r_perm[r_sorted], -1)
    return left_idx, right_idx


@trace_op
def join(left: Table, right: Table, left_on: Sequence[str], right_on: Sequence[str],
         how: str = "inner", nulls_equal: bool = False,
         suffixes: Tuple[str, str] = ("_x", "_y"), ordered: bool = True) -> Table:
    """Equi-join two tables. how: inner/left/right/semi/anti/full.

    ``ordered=False`` relaxes the output order to libcudf's contract (only
    the multiset of rows is promised), which lets an inner join build on
    its smaller side; ``ordered=True`` gives left-row order."""
    from .fastjoin import try_fast_join
    from .stream_compaction import apply_boolean_mask

    if how not in _HOWS:
        raise ValueError(f"unknown join type {how!r}")
    left_on, right_on = list(left_on), list(right_on)
    if how == "right":
        # pandas right join == swapped left join with the LEFT frame's
        # column order restored (libcudf's right join swaps sides too)
        sw = join(right, left, right_on, left_on, "left", nulls_equal,
                  (suffixes[1], suffixes[0]), ordered)
        return Table({n: sw[n] for n in _output_names(left.names, right.names, left_on,
                                                      right_on, suffixes)})
    if how == "full":
        return _full_join(left, right, left_on, right_on, nulls_equal, suffixes)

    fast = None
    if how == "inner" and not ordered and \
            _n_active(right, right_on, nulls_equal) > _n_active(left, left_on, nulls_equal):
        # the swap: the smaller side builds (libcudf's join.cu, the
        # reference's join.py:1217-1242)
        fast = try_fast_join(left, right, left_on, right_on, how, nulls_equal, suffixes,
                             build_left=True)
    if fast is None:
        fast = try_fast_join(left, right, left_on, right_on, how, nulls_equal, suffixes)
    if fast is not None:
        return fast

    lcols, rcols = _promote_keys(left, left_on, right, right_on)
    counts, lb, r_perm, linb = _probe(lcols, rcols, nulls_equal)
    if how in ("semi", "anti"):
        keep = (counts == 0) if how == "anti" else (counts > 0)
        return apply_boolean_mask(left, Column(dtypes.bool_, keep, None, left.num_rows))
    eff = torch.where(linb, counts.clamp(min=1), 0) if how == "left" else counts
    with annotate("host_read.join.n_out"):
        n_out = int(eff.sum().item())  # the one host read of the size pass
    left_idx, right_idx = _expand(counts, lb, r_perm, eff, n_out,
                                  bucket_capacity(max(n_out, 1)))
    left_cols = {n: gather(left[n], left_idx, n_out) for n in left.names}
    return _materialize(left_cols, right, left_on, right_on, right_idx, n_out, how,
                        suffixes)


def _n_active(tbl: Table, on: Sequence[str], nulls_equal: bool) -> int:
    """Rows that can match: in bounds and, unless ``nulls_equal``, with
    every key valid."""
    cols = [tbl[n] for n in on]
    if nulls_equal or all(c.validity is None for c in cols):
        return tbl.num_rows
    act = cols[0].bounds_mask()
    for c in cols:
        if c.validity is not None:
            act &= c.validity
    with annotate("host_read.join.n_active"):
        return int(act.sum().item())


def _right_payload(rnames, left_on, right_on) -> List[str]:
    """Right columns in the output: all but a key column whose name is
    also a left key's (the left one is emitted)."""
    return [n for n in rnames if not (n in right_on and n in left_on)]


def _output_names(lnames, rnames, left_on, right_on, suffixes) -> List[str]:
    """Output column names in order: left's, then the right payload's;
    other name clashes take suffixes."""
    key_pairs = dict(zip(left_on, right_on))
    return ([n if n not in rnames or n in key_pairs else n + suffixes[0] for n in lnames]
            + [n if n not in lnames else n + suffixes[1]
               for n in _right_payload(rnames, left_on, right_on)])


def _materialize(left_cols: Dict[str, Column], right: Table, left_on, right_on,
                 right_idx, n_out: int, how: str, suffixes) -> Table:
    """The output table: the left side's output columns (already gathered,
    or passed through), then each right payload column gathered at
    ``right_idx``, null where it is negative unless the join is inner."""
    names = _output_names(list(left_cols), right.names, left_on, right_on, suffixes)
    cols = list(left_cols.values()) + [
        gather(right[n], right_idx, n_out, check_bounds=(how != "inner"))
        for n in _right_payload(right.names, left_on, right_on)]
    return Table(dict(zip(names, cols)))


def _full_join(left, right, left_on, right_on, nulls_equal, suffixes) -> Table:
    """Full outer = left join + the unmatched right rows with a null left
    side. The keys are promoted first, so the two parts' key columns share
    one dtype (pandas: int32 against int64 gives int64)."""
    lcols, rcols = _promote_keys(left, left_on, right, right_on)
    for n, c in zip(left_on, lcols):
        left = left.with_column(n, c)
    for n, c in zip(right_on, rcols):
        right = right.with_column(n, c)
    lj = join(left, right, left_on, right_on, "left", nulls_equal, suffixes)
    r_only = join(right, left, right_on, left_on, "anti", nulls_equal)
    n = r_only.num_rows
    dev = lj.columns[0].device
    cols: Dict[str, Column] = {}
    for name in lj.names:
        if name in r_only.names:
            cols[name] = r_only[name]
        elif name in left.names and name in left_on:
            # key columns: take right values (same key domain)
            ridx = right_on[left_on.index(name)]
            cols[name] = (r_only[ridx] if ridx in r_only.names
                          else Column.from_scalar(None, n, lj[name].dtype, dev))
        else:
            src = lj[name]
            cols[name] = Column.from_scalar(None, n, src.dtype, dev)
            cols[name].dictionary = src.dictionary
    return concatenate_tables([lj, Table({k: cols[k] for k in lj.names})])


def cross_join(left: Table, right: Table) -> Table:
    """cudf::cross_join (cpp/src/join/cross_join.cu)."""
    nl, nr = left.num_rows, right.num_rows
    n_out = nl * nr
    dev = left.columns[0].device
    j = torch.arange(bucket_capacity(max(n_out, 1)), device=dev)
    left_idx, right_idx = j // max(nr, 1), j % max(nr, 1)
    out = {name: gather(left[name], left_idx, n_out) for name in left.names}
    lnames = set(left.names)
    for name in right.names:
        out[name if name not in lnames else name + "_y"] = gather(
            right[name], right_idx, n_out)
    return Table(out)


# Device bytes one (left, right) pair of a conditional join's block holds
# at its peak: its index, left and right rows (int64 each), the gathered
# predicate columns (8 bytes each, a few) with a gather's clamped indices,
# and the predicate's bool temporaries.
PAIR_BYTES = 128
# Pairs in a block where no memory limit applies (a CPU table without a
# chunk limit, or a CUDA table whose whole cross product fits).
MAX_BLOCK_PAIRS = 1 << 24


class _RecordingPairs:
    """A pair table that records which columns the predicate reads."""

    def __init__(self, tbl: Table):
        self._tbl = tbl
        self.accessed = set()
        self.saw_all = False

    @property
    def names(self):
        self.saw_all = True
        return self._tbl.names

    @property
    def num_rows(self):
        return self._tbl.num_rows

    def __contains__(self, name):
        return name in self._tbl

    def __getitem__(self, name):
        self.accessed.add(name)
        return self._tbl[name]

    def __iter__(self):
        self.saw_all = True
        return iter(self._tbl)


def _predicate_columns(left: Table, right: Table, predicate) -> set:
    """The pair columns the predicate reads, found on a 1 x 1 cross tile."""
    probe = cross_join(left.slice(0, min(left.num_rows, 1)),
                       right.slice(0, min(right.num_rows, 1)))
    rec = _RecordingPairs(probe)
    try:
        predicate(rec)
        needed = set(probe.names) if rec.saw_all else set(rec.accessed)
    except Exception:  # noqa: BLE001 - a predicate that fails on the probe reads all
        needed = set(probe.names)
    if not needed and probe.names:  # a constant predicate still needs a length
        needed = {probe.names[0]}
    return needed


def _block_rows(nl: int, nr: int, dev) -> int:
    """Left rows a block: the pair tile within the memory an op may use on
    ``dev`` (``chunked.memory_limit``), else MAX_BLOCK_PAIRS pairs. The
    tile's pairs are held to a power of two, the capacity bucket they are
    padded to."""
    from .chunked import memory_limit

    need = max(nl, 1) * max(nr, 1) * PAIR_BYTES
    limit = memory_limit(dev, need)
    if limit is None and need <= MAX_BLOCK_PAIRS * PAIR_BYTES:
        return max(nl, 1)
    pairs = MAX_BLOCK_PAIRS if limit is None else max(limit // PAIR_BYTES, 1)
    pairs = 1 << (pairs.bit_length() - 1)
    return max(1, min(max(nl, 1), pairs // max(nr, 1)))


def _with_null_right(matched: Table, unmatched: Table) -> Table:
    """``matched`` ++ the ``unmatched`` left rows with null right columns."""
    dev = unmatched.device
    cols = {}
    for name in matched.names:
        if name in unmatched.names:
            cols[name] = unmatched[name]
        else:
            src = matched[name]
            cols[name] = Column.from_scalar(None, unmatched.num_rows, src.dtype, dev)
            cols[name].dictionary = src.dictionary
    return concatenate_tables([matched, Table({k: cols[k] for k in matched.names})])


def conditional_join(left: Table, right: Table, predicate, how: str = "inner",
                     block_rows: int = None) -> Table:
    """Join on an arbitrary row-pair predicate (cudf::conditional_*_join,
    cpp/src/join/conditional_join.cu). how: inner/left/semi/anti.

    ``predicate(pairs: Table) -> Column[bool]`` sees each block of left rows
    crossed with the whole right table, holding only the columns it reads
    (a right column whose name a left one has takes the suffix ``_y``).
    Each block sizes and retrieves its matching (left, right) index pairs
    at once (``torch.nonzero``) and then drops its tile, so the device
    holds O(block x |R|) transiently and O(|L| + |R| + out) after; one
    gather per output column follows. Rows come in left-row order, and
    within a left row in right-row order, whatever the block size, which is
    taken from the memory the card has free (``_block_rows``) unless
    given."""
    from .stream_compaction import apply_boolean_mask

    if how not in ("inner", "left", "semi", "anti"):
        raise ValueError(f"conditional_join: unsupported how {how!r}")
    nl, nr = left.num_rows, right.num_rows
    lset = set(left.names)
    rmap = {n: (n if n not in lset else n + "_y") for n in right.names}
    needed = _predicate_columns(left, right, predicate)
    dev = left.device if left.num_columns else right.device
    if block_rows is None:
        block_rows = _block_rows(nl, nr, dev)
    need_flags = how != "inner"
    matched = torch.zeros(nl + 1, dtype=torch.bool, device=dev)
    l_parts, r_parts = [], []
    for start in range(0, nl, block_rows):
        n_out = min(block_rows, nl - start) * nr
        if n_out == 0:
            continue
        j = torch.arange(bucket_capacity(n_out), device=dev)
        li, ri = j // nr + start, j % nr
        cols = {n: gather(left[n], li, n_out) for n in left.names if n in needed}
        cols.update({c: gather(right[r], ri, n_out) for r, c in rmap.items()
                     if c in needed})
        mask = predicate(Table(cols))
        keep = mask.data[:n_out].to(torch.bool)
        if mask.validity is not None:
            keep &= mask.validity[:n_out]
        with annotate("host_read.join.conditional_hits"):
            hit = torch.nonzero(keep).squeeze(1)
        if need_flags:
            matched[li[hit]] = True
        if how in ("inner", "left"):
            l_parts.append(li[hit])
            r_parts.append(ri[hit])
    if how in ("semi", "anti"):
        flags = matched[:nl] if how == "semi" else ~matched[:nl]
        data = torch.zeros(bucket_capacity(nl), dtype=torch.bool, device=dev)
        data[:nl] = flags
        return apply_boolean_mask(left, Column(dtypes.bool_, data, None, nl))
    lidx = torch.cat(l_parts) if l_parts else torch.zeros(0, dtype=torch.int64, device=dev)
    ridx = torch.cat(r_parts) if r_parts else torch.zeros(0, dtype=torch.int64, device=dev)
    total = lidx.shape[0]
    cap = bucket_capacity(total)
    lg = torch.zeros(cap, dtype=torch.int64, device=dev)
    rg = torch.zeros(cap, dtype=torch.int64, device=dev)
    lg[:total], rg[:total] = lidx, ridx
    inner = Table({**{n: gather(left[n], lg, total) for n in left.names},
                   **{rmap[n]: gather(right[n], rg, total) for n in right.names}})
    if how == "inner":
        return inner
    data = torch.zeros(bucket_capacity(nl), dtype=torch.bool, device=dev)
    data[:nl] = ~matched[:nl]
    return _with_null_right(inner, apply_boolean_mask(
        left, Column(dtypes.bool_, data, None, nl)))


def mixed_join(left: Table, right: Table, left_on, right_on, predicate,
               how: str = "inner", nulls_equal: bool = False) -> Table:
    """Equality keys plus a residual predicate (cudf::mixed_*_join,
    cpp/src/join/mixed_join.cu). how: inner/left/semi/anti.

    The equi-join runs on ``join``'s dispatch (the hash-table lane and its
    probe kernel where it applies), then the predicate filters its pairs.
    For left/semi/anti the pairs carry their left row id, and a scatter of
    the surviving ids marks the left rows that matched. Rows of inner come
    in the equi-join's order, of semi and anti in left-row order, and left
    is inner's rows followed by the unmatched left rows with null right
    columns."""
    from .filling import sequence
    from .stream_compaction import apply_boolean_mask

    if how not in ("inner", "left", "semi", "anti"):
        raise ValueError(f"mixed_join: unsupported how {how!r}")
    left_on, right_on = list(left_on), list(right_on)
    if how == "inner":
        eq = join(left, right, left_on, right_on, "inner", nulls_equal)
        return apply_boolean_mask(eq, predicate(eq))
    lid = "__mixed_lid"
    nl = left.num_rows
    dev = left.device
    eq = join(left.with_column(lid, sequence(nl, device=dev)), right, left_on, right_on,
              "inner", nulls_equal)
    mask = predicate(eq)
    keep = mask.valid_mask() & mask.data.to(torch.bool)
    ids = eq[lid].data
    matched = torch.zeros(nl + 1, dtype=torch.bool, device=dev)
    matched[torch.where(keep, ids, nl)] = True
    flags = torch.zeros(bucket_capacity(nl), dtype=torch.bool, device=dev)
    flags[:nl] = matched[:nl] if how == "semi" else ~matched[:nl]
    rows = apply_boolean_mask(left, Column(dtypes.bool_, flags, None, nl))
    if how in ("semi", "anti"):
        return rows
    hit = apply_boolean_mask(eq, Column(dtypes.bool_, keep, None, eq.num_rows)).drop([lid])
    return _with_null_right(hit, rows)
