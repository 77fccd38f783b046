"""The distinct/dimension-join lane on the hash table (counterpart of
``cudf_tpu/ops/fastjoin.py``; libcudf's distinct_hash_join.cu).

The reference's lane is a direct-address table whose size (2^22 slots)
and word-sort neighbours were shaped by TPU compile limits. Here the lane
is the hash table of ``kernels/hashtable.py``:

  1. promote the key pairs to common dtypes (``join._promote_keys``);
  2. pack both sides' equality operands, the null flag always among them,
     into two 32-bit words with one shared packing
     (``hashgroup.pack_key_words(..., joint_with=...)``);
  3. ``build_table`` over the right side's active rows (in bounds and,
     unless ``nulls_equal``, with a valid key), in a larger table while
     some row finds no slot (``MAX_GROWTH``);
  4. refuse (return None) when the keys do not pack into 64 bits, when a
     row found no slot in the largest table, or — for inner and left
     joins — when the build side is not distinct (fewer occupied slots
     than active rows). Semi and anti joins only ask whether a key
     exists, so duplicates are fine;
  5. ``probe_table`` with the left side's words: a left row matches when
     the payload is a row id and the row is active (no launch when a side
     has no rows: its padding would only find ``EMPTY``);
  6. inner: the matched left rows in left-row order, each right column
     gathered at the payload; left: every left row passes through as it
     is, the right columns gathered and null where there is no match;
     semi/anti: the match mask, then ``apply_boolean_mask``;
  7. ``build_left`` (an unordered inner join whose left side is the
     smaller, ``join``'s swap): steps 2-5 with the sides exchanged, then
     the matched right rows in right-row order, each left column gathered
     at the payload; the output's columns are those of step 6.

The lane choice depends only on the data. A CUDA tensor always takes the
probe kernel; nothing is caught.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..kernels import hashtable as ht
from ..utils.padding import bucket_capacity
from ..utils.tracing import annotate
from . import hashgroup
from .copying import gather

# Linear probing at table_size_for's <= 50% load can leave a key more than
# MAX_PROBE slots from its home on a large build side (the 7,289,153 TPC-H
# SF10 order keys of chip_smoke.py's join leave rows unplaced in 2^24 slots
# and place in 2^25). A build that leaves a row unplaced is retried in a
# table twice the size, up to 2^MAX_GROWTH times table_size_for.
MAX_GROWTH = 3


def _active(cols, nulls_equal: bool) -> torch.Tensor:
    act = cols[0].bounds_mask()
    if not nulls_equal:
        for c in cols:
            if c.validity is not None:
                act = act & c.validity
    return act


def build_hash_table(lcols, rcols, nulls_equal: bool):
    """Steps 2-3 for promoted key columns: (left words (q1, q2), table
    (tk1, tk2, payload), active build rows), or None when the keys do not
    pack into 64 bits or a row finds no slot in the largest table. One
    ``hash_build`` range, a ``hash_build.round`` in it for each size."""
    from .join import _join_key_operands

    with annotate("hash_build"):
        r_words, _, mins, widths = hashgroup.pack_key_words(
            _join_key_operands(rcols), joint_with=_join_key_operands(lcols))
        if r_words is None:
            return None
        r_act = _active(rcols, nulls_equal)
        with annotate("host_read.fastjoin.n_build"):
            n_build = int(r_act.sum().item())
        m = ht.table_size_for(n_build)
        for _ in range(MAX_GROWTH + 1):
            with annotate("hash_build.round"):
                tk1, tk2, payload, all_placed = ht.build_table(*r_words, r_act, m)
            if all_placed:
                l_words = hashgroup.pack_like(_join_key_operands(lcols), mins, widths)
                return l_words, (tk1, tk2, payload), n_build
            m *= 2
        return None


def _match(probe: Table, build: Table, probe_on: Sequence[str],
           build_on: Sequence[str], nulls_equal: bool, distinct: bool):
    """Steps 1-5 with ``build`` as the build side: (hit, matched) for each
    probe row, or None when the lane does not apply (with ``distinct``,
    also when a build key repeats)."""
    from .join import _promote_keys

    pcols, bcols = _promote_keys(probe, probe_on, build, build_on)
    built = build_hash_table(pcols, bcols, nulls_equal)
    if built is None:
        return None
    p_words, table, n_build = built
    if distinct:
        with annotate("host_read.fastjoin.distinct"):
            occupied = int((table[2] != ht.EMPTY).sum().item())
        if occupied != n_build:
            return None  # duplicate build keys: the general lane expands them
    if probe.num_rows and build.num_rows:
        hit = ht.probe_table(*table, *p_words)
    else:  # padding rows only on a side: nothing can match, nothing launches
        hit = torch.full_like(p_words[0], ht.EMPTY)
    return hit, (hit >= 0) & _active(pcols, nulls_equal)


def _gather_rows(tbl: Table, rows: torch.Tensor, n_out: int) -> dict:
    idx = torch.zeros(bucket_capacity(max(n_out, 1)), dtype=torch.int64,
                      device=rows.device)
    idx[:n_out] = rows
    return {n: gather(tbl[n], idx, n_out) for n in tbl.names}


def try_fast_join(left: Table, right: Table, left_on: Sequence[str],
                  right_on: Sequence[str], how: str, nulls_equal: bool,
                  suffixes: Tuple[str, str], build_left: bool = False) -> Optional[Table]:
    """Hash-table join for distinct build sides; None when it does not apply.

    ``build_left`` (inner joins only) builds on the left side and probes
    with the right: the output has the same columns, in right-row order."""
    from .join import _materialize
    from .stream_compaction import apply_boolean_mask

    if how not in ("inner", "left", "semi", "anti"):
        return None
    if build_left:
        if how != "inner":
            raise ValueError(f"only an inner join builds on its left side, not {how!r}")
        found = _match(right, left, right_on, left_on, nulls_equal, True)
        if found is None:
            return None
        hit, matched = found
        with annotate("host_read.fastjoin.matched"):
            rows = torch.nonzero(matched).squeeze(1)
        n_out = rows.numel()
        left_cols = _gather_rows(left, hit[rows], n_out)
        right_idx = torch.full((bucket_capacity(max(n_out, 1)),), -1, dtype=torch.int64,
                               device=rows.device)
        right_idx[:n_out] = rows
        return _materialize(left_cols, right, list(left_on), list(right_on), right_idx,
                            n_out, how, suffixes)
    found = _match(left, right, left_on, right_on, nulls_equal, how in ("inner", "left"))
    if found is None:
        return None
    hit, matched = found

    if how in ("semi", "anti"):
        keep = ~matched if how == "anti" else matched
        return apply_boolean_mask(left, Column(dtypes.bool_, keep, None, left.num_rows))

    if how == "left":
        n_out = left.num_rows
        left_cols = {n: left[n] for n in left.names}  # zero-copy
        right_idx = torch.where(matched, hit, -1)
    else:
        with annotate("host_read.fastjoin.matched"):
            rows = torch.nonzero(matched).squeeze(1)
        n_out = rows.numel()
        if n_out == left.num_rows:
            left_cols = {n: left[n] for n in left.names}  # every row matched
            right_idx = hit
        else:
            right_idx = torch.full((bucket_capacity(max(n_out, 1)),), -1,
                                   dtype=torch.int32, device=hit.device)
            right_idx[:n_out] = hit[rows]
            left_cols = _gather_rows(left, rows, n_out)
    return _materialize(left_cols, right, list(left_on), list(right_on), right_idx,
                        n_out, how, suffixes)
