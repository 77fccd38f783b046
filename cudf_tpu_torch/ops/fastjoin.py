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
     the payload is a row id and the row is active;
  6. inner: the matched left rows in left-row order, each right column
     gathered at the payload; left: every left row passes through as it
     is, the right columns gathered and null where there is no match;
     semi/anti: the match mask, then ``apply_boolean_mask``.

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
    pack into 64 bits or a row finds no slot in the largest table."""
    from .join import _join_key_operands

    r_words, _, mins, widths = hashgroup.pack_key_words(
        _join_key_operands(rcols), joint_with=_join_key_operands(lcols))
    if r_words is None:
        return None
    r_act = _active(rcols, nulls_equal)
    n_build = int(r_act.sum().item())
    m = ht.table_size_for(n_build)
    for _ in range(MAX_GROWTH + 1):
        tk1, tk2, payload, all_placed = ht.build_table(*r_words, r_act, m)
        if all_placed:
            l_words = hashgroup.pack_like(_join_key_operands(lcols), mins, widths)
            return l_words, (tk1, tk2, payload), n_build
        m *= 2
    return None


def try_fast_join(left: Table, right: Table, left_on: Sequence[str],
                  right_on: Sequence[str], how: str, nulls_equal: bool,
                  suffixes: Tuple[str, str]) -> Optional[Table]:
    """Hash-table join for distinct build sides; None when it does not apply."""
    from .join import _materialize, _promote_keys
    from .stream_compaction import apply_boolean_mask

    if how not in ("inner", "left", "semi", "anti"):
        return None
    lcols, rcols = _promote_keys(left, left_on, right, right_on)
    built = build_hash_table(lcols, rcols, nulls_equal)
    if built is None:
        return None
    l_words, table, n_build = built
    if how in ("inner", "left") and int((table[2] != ht.EMPTY).sum().item()) != n_build:
        return None  # duplicate build keys: the general lane expands them
    hit = ht.probe_table(*table, *l_words)
    matched = (hit >= 0) & _active(lcols, nulls_equal)

    if how in ("semi", "anti"):
        keep = ~matched if how == "anti" else matched
        return apply_boolean_mask(left, Column(dtypes.bool_, keep, None, left.num_rows))

    if how == "left":
        n_out = left.num_rows
        left_cols = {n: left[n] for n in left.names}  # zero-copy
        right_idx = torch.where(matched, hit, -1)
    else:
        rows = torch.nonzero(matched).squeeze(1)
        n_out = rows.numel()
        if n_out == left.num_rows:
            left_cols = {n: left[n] for n in left.names}  # every row matched
            right_idx = hit
        else:
            out_cap = bucket_capacity(max(n_out, 1))
            left_idx = torch.zeros(out_cap, dtype=torch.int64, device=hit.device)
            left_idx[:n_out] = rows
            right_idx = torch.full((out_cap,), -1, dtype=torch.int32, device=hit.device)
            right_idx[:n_out] = hit[rows]
            left_cols = {n: gather(left[n], left_idx, n_out) for n in left.names}
    return _materialize(left_cols, right, list(left_on), list(right_on), right_idx,
                        n_out, how, suffixes)
