"""Interval columns and cut/qcut binning (counterpart of
``cudf_tpu/core/interval.py``).

Analog of python/cudf/cudf/core/column/interval.py (an IntervalColumn is a
struct of left and right children) and cudf.cut (python/cudf/cudf/core/
cut.py). ``cut`` and ``qcut`` bin on the device with one ``searchsorted``
of the values into the (few) edges and return an ordered categorical whose
categories are the reference's interval labels, in bin order.

The edges follow pandas' arithmetic, so the codes equal ``pandas.cut`` and
``pandas.qcut``: integer ``bins`` take the data's min and max as numpy
scalars of the column's dtype (read from the device), ``np.linspace``
between them and widen the first edge (``right=True``) or the last
(``right=False``) by 0.1% of the range; ``qcut``'s edges are pandas'
quantiles of the column read to the host; values compare with the edges
in their common numpy type. Faults of the reference not copied: it
computes integer bins in float64 whatever the data's type, so on float32
data a value next to an edge can fall in the neighbouring bin, and it
widens the first edge for ``right=False`` too, so the maximum is null.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import dtypes
from .categorical import categorical_dtype
from .column import Column


@dataclasses.dataclass
class IntervalColumn:
    """Struct of (left, right) interval rows; closed: left/right/both/neither."""

    left: Column
    right: Column
    closed: str = "right"

    @property
    def length(self) -> int:
        return self.left.length

    def mid(self) -> Column:
        data = (self.left.data.to(torch.float64) + self.right.data.to(torch.float64)) / 2.0
        return Column(dtypes.float64, data, self.left.validity, self.length)

    def width(self) -> Column:
        return Column(self.left.dtype, self.right.data - self.left.data,
                      self.left.validity, self.length)

    def contains(self, value) -> Column:
        lo = (self.left.data <= value if self.closed in ("left", "both")
              else self.left.data < value)
        hi = (self.right.data >= value if self.closed in ("right", "both")
              else self.right.data > value)
        return Column(dtypes.bool_, lo & hi, self.left.validity, self.length)

    def overlaps(self, other: "IntervalColumn") -> Column:
        """Closed-aware pairwise overlap of equal-length interval columns."""
        strict_l = not (self.closed in ("right", "both") and other.closed in ("left", "both"))
        strict_r = not (self.closed in ("left", "both") and other.closed in ("right", "both"))

        def lt(a, b, strict):
            return a < b if strict else a <= b

        ok = lt(other.left.data, self.right.data, strict_l) & \
            lt(self.left.data, other.right.data, strict_r)
        return Column(dtypes.bool_, ok, self.left.validity, self.length)

    def to_pandas(self):
        from ..utils.real_pandas import pd

        return pd.arrays.IntervalArray.from_arrays(self.left.to_numpy(),
                                                   self.right.to_numpy(), closed=self.closed)


def interval_range(start, end, periods: Optional[int] = None, freq=None,
                   closed: str = "right", device=None) -> IntervalColumn:
    """cudf.interval_range analog."""
    if freq is None:
        edges = np.linspace(start, end, int(periods) + 1)
    else:
        edges = np.arange(start, end + freq, freq)
    return IntervalColumn(Column.from_numpy(edges[:-1], device=device),
                          Column.from_numpy(edges[1:], device=device), closed)


def _interval_labels(edges: np.ndarray, right: bool, precision: int = 3) -> np.ndarray:
    """The reference's category labels, "(a, b]" or "[a, b)"."""
    lo, hi = ("(", "]") if right else ("[", ")")

    def fmt(x):
        if float(x) == int(x) and abs(x) < 1e15:
            return str(int(x)) if isinstance(x, (int, np.integer)) else f"{x:.1f}"
        return f"{np.round(x, precision)}"

    return np.array([f"{lo}{fmt(a)}, {fmt(b)}{hi}" for a, b in zip(edges[:-1], edges[1:])],
                    dtype=object)


def _valid_values(col: Column) -> torch.Tensor:
    n = col.length
    x = col.data[:n]
    ok = col.valid_mask()[:n]
    if col.dtype.is_floating:
        ok = ok & ~torch.isnan(x)
    return x[ok]


def _equal_width_edges(col: Column, nbins: int, right: bool):
    """(edges to bin with, edges to label with): pandas' ``_nbins_to_bins``
    on the column's min and max, and the reference's float64 edges."""
    np_dt = dtypes.to_numpy(col.dtype)
    vals = _valid_values(col)
    if vals.numel():
        lo, hi = torch.aminmax(vals)
        mn, mx = np_dt.type(lo.item()), np_dt.type(hi.item())
    else:
        mn, mx = np.float64(0.0), np.float64(1.0)
    fmn, fmx = float(mn), float(mx)
    if mn == mx:
        mn = mn - (0.001 * abs(mn) if mn != 0 else 0.001)
        mx = mx + (0.001 * abs(mx) if mx != 0 else 0.001)
        bins = np.linspace(mn, mx, nbins + 1, endpoint=True)
        fmn -= 0.001 * abs(fmn) if fmn != 0 else 0.001
        fmx += 0.001 * abs(fmx) if fmx != 0 else 0.001
    else:
        bins = np.linspace(mn, mx, nbins + 1, endpoint=True)
        adj = (mx - mn) * 0.001
        if right:
            bins[0] -= adj
        else:
            bins[-1] += adj
    return bins, np.linspace(fmn, fmx, nbins + 1)


def _bin_codes(col: Column, edges: np.ndarray, right: bool, include_lowest: bool):
    """(codes, ok) on the device: pandas' ``bins.searchsorted(x)`` in the
    common type of the values and the edges."""
    common = np.result_type(edges.dtype, dtypes.to_numpy(col.dtype))
    tdt = dtypes.from_numpy(common).physical
    x = col.data.to(tdt)
    e = torch.from_numpy(np.ascontiguousarray(edges.astype(common))).to(col.device)
    ids = torch.searchsorted(e, x, right=not right)
    if include_lowest:
        ids = torch.where(x == e[0], 1, ids)
    ok = col.valid_mask() & (ids > 0) & (ids < len(edges))
    if col.dtype.is_floating:
        ok = ok & ~torch.isnan(x)
    return torch.where(ok, ids - 1, 0).to(torch.int32), ok


def cut(col: Column, bins, right: bool = True, labels=None, include_lowest: bool = False,
        precision: int = 3) -> Column:
    """pandas.cut analog: bin the values into intervals, as an ordered
    categorical. ``bins``: an int (equal width over the data's range) or
    the edges. ``labels=False`` gives the int32 bin numbers (-1 outside)."""
    if isinstance(bins, (int, np.integer)):
        edges, label_edges = _equal_width_edges(col, int(bins), right)
    else:
        edges = label_edges = np.asarray(list(bins), np.float64)
    codes, ok = _bin_codes(col, edges, right, include_lowest)
    nbins = len(edges) - 1
    if labels is False:
        return Column(dtypes.int32, torch.where(ok, codes, -1), None, col.length)
    if labels is None:
        cats = _interval_labels(np.round(label_edges, precision), right, precision)
    else:
        cats = np.asarray(list(labels), dtype=object)
        if len(cats) != nbins:
            raise ValueError("cut: labels must have one entry a bin")
    return Column(categorical_dtype(True), codes, ok, col.length, dictionary=cats)


def qcut(col: Column, q, precision: int = 3, labels=None) -> Column:
    """pandas.qcut analog: quantile edges (pandas' own, from the column
    read to the host), then ``cut`` with ``include_lowest``; repeated
    edges are dropped."""
    from ..utils.real_pandas import pd

    if isinstance(q, (int, np.integer)):
        qs = np.linspace(0, 1, int(q) + 1)
        np.putmask(qs, int(q) * qs != np.arange(int(q) + 1), np.nextafter(qs, 1))
    else:
        qs = np.asarray(list(q), np.float64)
    host = pd.Series(_valid_values(col).cpu().numpy())
    edges = np.unique(host.quantile(qs).to_numpy())
    return cut(col, edges, right=True, labels=labels, include_lowest=True,
               precision=precision)
