"""Dense-slot groupby lane: sums, means, counts and sizes by keys that pack
into at most ``fastgroup.ONEHOT_MAX_BITS`` code bits, in one kernel pass
with no sort (``kernels/dense_groupby.py``). No counterpart in
``cudf_tpu/``, whose sort lanes answer these groupbys.

The packed key code is already a dense group id: the kernel sums each
value column into its slot (float columns in float64, integer and bool
columns in int64) beside the slot's row count and each nullable column's
valid count, over the table's rows and never its capacity. The occupied
slots, in slot order (key order, nulls last), become the groups, and
their keys decode as the sort lane's do (``fastgroup.decode_keys``). The
output's columns, dtypes and nulls are the sort lane's: a sum of float32
or bfloat16 comes back float32, of float64 float64, of an integer or
bool int64; a mean float64; a count or a size int64; a sum or mean of a
group with no valid value is null.

The lane takes a groupby when every aggregation is in
``fastgroup.ONEHOT_KINDS``, every value column is a bool, integer or float
column, at most ``kernels.dense_groupby.MAX_VALUES`` of them, and the
slots and accumulators fit one of the kernel's tiers; otherwise it
returns None and the sort lane answers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import Kind
from ..core.table import Table
from ..kernels import dense_groupby as kernel
from . import fastgroup

_SUMMABLE = (Kind.BOOL, Kind.INT, Kind.UINT, Kind.FLOAT)


def _key(c: Column, st, w: int) -> kernel.Key:
    nan_code = st.value_range
    vmin = st.vmin if c.dtype.kind == Kind.FLOAT else fastgroup._vmin_signed(c, st)
    return kernel.Key(c.data, c.validity, vmin, w, nan_code,
                      nan_code + (1 if st.has_nan else 0))


def dense_groupby(tbl: Table, keys: Sequence[str], aggs,
                  dropna_keys: bool) -> Optional[Table]:
    """The dense-slot lane's answer, or None when it does not apply."""
    if not all(s.kind in fastgroup.ONEHOT_KINDS for s in aggs):
        return None
    names = list(dict.fromkeys(s.column or keys[0] for s in aggs if s.kind != "size"))
    vcols = [tbl[n] for n in names]
    if len(vcols) > kernel.MAX_VALUES or len(keys) > kernel.MAX_KEYS or \
            not all(c.dtype.kind in _SUMMABLE for c in vcols):
        return None
    kcols = [tbl[k] for k in keys]
    plan = fastgroup.plan_codes(kcols, fastgroup.ONEHOT_MAX_BITS)
    if plan is None:
        return None
    n_slots = 1 << sum(w for _, w in plan)
    summed = {s.column or keys[0] for s in aggs if s.kind in ("sum", "mean")}
    accs = [kernel.Acc(kernel.ROWS)]
    at = {}  # value column -> (its sum's accumulator or None, its count's or None)
    for name, c in zip(names, vcols):
        si = ci = None
        if name in summed:
            si = len(accs)
            kind = kernel.SUM_F if c.dtype.is_floating else kernel.SUM_I
            accs.append(kernel.Acc(kind, c.data, c.validity))
        if c.validity is not None:
            ci = len(accs)
            accs.append(kernel.Acc(kernel.COUNT, None, c.validity))
        at[name] = (si, ci)
    if kernel.tier(n_slots, [a.kind for a in accs]) is None:
        return None

    n = kcols[0].length
    keyspecs = [_key(c, st, w) for c, (st, w) in zip(kcols, plan)]
    if n == 0:  # no rows: no slot is occupied, and nothing is launched
        out = torch.zeros((n_slots, len(accs)), dtype=torch.int64, device=kcols[0].device)
    else:
        out = kernel.dense_groupby(keyspecs, accs, n, n_slots, dropna_keys)
    slots = torch.nonzero(out[:, 0] > 0).squeeze(1)
    n_groups = slots.shape[0]
    g = out[slots]
    rows = g[:, 0]
    cols = fastgroup.decode_keys(keys, kcols, plan, slots, n_groups)
    for spec in aggs:
        if spec.kind == "size":
            cols[spec.out_name] = fastgroup.padded_column(dtypes.int64, rows, None, n_groups)
            continue
        vcol = tbl[spec.column or keys[0]]
        si, ci = at[spec.column or keys[0]]
        cnt = rows if ci is None else g[:, ci]
        if spec.kind == "count":
            cols[spec.out_name] = fastgroup.padded_column(dtypes.int64, cnt, None, n_groups)
            continue
        s = g[:, si]
        if vcol.dtype.is_floating:
            s = s.view(torch.float64)
        if spec.kind == "mean":
            data, dt = s.to(torch.float64) / cnt.clamp(min=1), dtypes.float64
        elif vcol.dtype.is_floating and vcol.dtype.bits <= 32:
            data, dt = s.to(torch.float32), dtypes.float32
        else:
            data, dt = s, fastgroup._dtype_of(s)
        cols[spec.out_name] = fastgroup.padded_column(dt, data, cnt > 0, n_groups)
    return Table({n: cols[n] for n in list(keys) + [s.out_name for s in aggs]})
