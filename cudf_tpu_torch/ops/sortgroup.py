"""Single-word code-sort groupby (counterpart of ``cudf_tpu/ops/sortgroup.py``).

  1. key columns compress to exact integer codes from cached stats (64-bit
     integers keep exact Python-int bounds), packed into ONE word of <= 63
     code bits under a leading inactive-sentinel bit, so sparse 64-bit keys
     fit;
  2. one stable sort by that word, as int64: below 63 code bits the word
     is non-negative and sorts as it is; at 63 its top bit is flipped, so
     that signed order is the word's unsigned order;
  3. every aggregate, sums, counts and M2 included, is a per-group
     reduction over the sorted rows (``fastgroup.aggregate_sorted``) by
     ``sortprim.segment_reduce``, whose module (``kernels/segment_reduce.py``)
     states what a group's sum promises;
  4. each group's first row, in key order, carries the key word.

The reference takes a group's sum as the difference of two prefix sums
over the whole sorted table, which spreads a NaN into every later group and
costs a small group the precision of the running total; a segment
reduction does neither.

The reference also splits this path past ``SORT_OPERAND_MAX`` to cap TPU
compile time; the GPU has no such limit and runs one path, whose results
match both of the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import stats as colstats
from ..core.column import Column
from ..core.table import Table
from . import fastgroup
from .fastgroup import _I64_MIN

# every kind of fastgroup.aggregate_sorted, argmin/argmax included (the
# reference leaves those two to its fastgroup.fast_groupby, which sorts the
# same rows by a narrower word and was no faster on the H100), and corr,
# which the other sorted lanes do not take
_SUPPORTED = fastgroup._SUPPORTED | {"corr"}

MAX_CODE_BITS = 63  # one 64-bit word minus the inactive-sentinel bit


def plan_wide(kcols: Sequence[Column]):
    """Per-key (stats, width) with EXACT wide codes, total <= MAX_CODE_BITS;
    None when any key is not integral-codeable or the pack is too wide."""
    plan = []
    total = 0
    for c in kcols:
        st = colstats.compute_stats(c)
        if st is None:
            return None
        w = st.code_width_wide()
        if w is None:
            return None
        plan.append((st, w))
        total += w
    if total > MAX_CODE_BITS:
        return None
    return plan


def _make_word(kcols: Sequence[Column], plan, dropna: bool):
    """(word, flip): int64 [sentinel:1][packed codes:tbits] XOR ``flip``;
    the sentinel marks padding / dropped-null rows (sort last). ``flip`` is
    INT64_MIN only when the sentinel needs the top bit (tbits = 63), else 0,
    which spares a pass over the word before the sort and over the group
    starts after it."""
    slot, active = fastgroup._make_key(kcols, plan, dropna)
    tbits = sum(w for _, w in plan)
    flip = _I64_MIN if tbits == MAX_CODE_BITS else 0
    if flip:
        slot = slot ^ flip
    return torch.where(active, slot, (1 << tbits) + flip), flip


def sort_groupby(tbl: Table, keys: Sequence[str], aggs,
                 dropna_keys: bool) -> Optional[Table]:
    """Single-word code-sort groupby; None when this plan doesn't apply."""
    if not all(s.kind in _SUPPORTED for s in aggs):
        return None
    kcols = [tbl[k] for k in keys]
    plan = plan_wide(kcols)
    if plan is None:
        return None
    tbits = sum(w for _, w in plan)
    word, flip = _make_word(kcols, plan, dropna_keys)
    skey, pos = torch.sort(word, stable=True)
    act = skey < (1 << tbits) + flip
    out, starts, n_groups = fastgroup.aggregate_sorted(
        tbl, keys, aggs, pos, act, fastgroup.new_groups(skey, act))
    first = skey[starts] ^ flip if flip else skey[starts]
    out.update(fastgroup.decode_keys(keys, kcols, plan, first, n_groups))
    return Table({n: out[n] for n in list(keys) + [s.out_name for s in aggs]})
