"""t-digest quantile sketches and HyperLogLog distinct counts (counterpart
of ``cudf_tpu/ops/tdigest.py``).

Analog of cpp/src/quantiles/tdigest/ (the TDIGEST and MERGE_TDIGEST
aggregations, include/cudf/aggregation.hpp:79-124) and the HLL
approx_distinct_count reduction (cpp/src/reductions/).

A t-digest over sorted data is a binning problem: with the k1 scale
function, the centroid of the i-th sorted value depends only on its
quantile (i + 0.5) / n. So a build is a sort, a scale-function bin and a
segmented mean, into K = delta / 2 + 2 slots (an empty slot weighs 0);
a merge re-bins the union of the centroids by their cumulative-weight
midpoints. As in the reference. Not copied from it: its quantile lookup
binary-searches midpoints in which empty slots read +inf, which are not
sorted when an empty slot sits between two full ones; here the lookup
runs over the non-empty centroids only.

HLL: 2^12 registers over the murmur3 row hash (``hashing.hash_columns``,
the reference's bit for bit): the top 12 bits pick the register, the rank
is one more than the leading zeros of the other 20. Registers equal the
reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..utils.padding import bucket_capacity
from . import hashing


class TDigest(NamedTuple):
    """Fixed-capacity centroids, ordered by mean; weight 0 is an empty slot."""

    means: torch.Tensor    # f64[K]
    weights: torch.Tensor  # f64[K]
    vmin: float
    vmax: float


def _capacity(delta: int) -> int:
    return int(delta) // 2 + 2


def _k1_bin(q: torch.Tensor, delta: int) -> torch.Tensor:
    """k1 scale function: the centroid id in [0, delta / 2 + 1]."""
    k = (delta / (2.0 * math.pi)) * torch.asin(torch.clamp(2.0 * q - 1.0, -1.0, 1.0))
    return torch.clamp(torch.floor(k + delta / 4.0).to(torch.int64), 0, _capacity(delta) - 1)


def _binned(values: torch.Tensor, weights: torch.Tensor, cid: torch.Tensor, K: int):
    sums = torch.zeros(K, dtype=torch.float64, device=values.device)
    wts = torch.zeros(K, dtype=torch.float64, device=values.device)
    sums.index_add_(0, cid, values * weights)
    wts.index_add_(0, cid, weights)
    return torch.where(wts > 0, sums / wts.clamp(min=1.0), 0.0), wts


def tdigest(col: Column, delta: int = 100) -> TDigest:
    """Sketch a numeric column (TDIGEST): nulls and NaN are skipped."""
    delta = int(delta)
    n = col.length
    x = col.data[:n].to(torch.float64)
    valid = col.valid_mask()[:n] & ~torch.isnan(x)
    xs = torch.sort(x[valid]).values
    cnt = xs.shape[0]
    q = (torch.arange(cnt, dtype=torch.float64, device=x.device) + 0.5) / max(cnt, 1)
    means, wts = _binned(xs, torch.ones_like(xs), _k1_bin(q, delta), _capacity(delta))
    vmin = float(xs[0]) if cnt else math.inf
    vmax = float(xs[-1]) if cnt else -math.inf
    return TDigest(means, wts, vmin, vmax)


def merge_tdigest(digests: Sequence[TDigest], delta: int = 100) -> TDigest:
    """MERGE_TDIGEST: combine partial sketches (the distributed path)."""
    delta = int(delta)
    means = torch.cat([d.means for d in digests])
    weights = torch.cat([d.weights for d in digests])
    order = torch.sort(torch.where(weights > 0, means, math.inf), stable=True).indices
    m, w = means[order], weights[order]
    cum = torch.cumsum(w, 0)
    qmid = (cum - w * 0.5) / max(float(w.sum()), 1.0)
    out_means, wts = _binned(m, w, _k1_bin(qmid, delta), _capacity(delta))
    return TDigest(out_means, wts, min(d.vmin for d in digests),
                   max(d.vmax for d in digests))


def tdigest_quantile(td: TDigest, qs) -> Column:
    """Approximate quantiles (percentile_approx): linear interpolation
    between the non-empty centroids' weight midpoints, clamped to the
    data's min and max."""
    qs_t = torch.as_tensor(np.atleast_1d(np.asarray(qs, np.float64)), device=td.means.device)
    full = td.weights > 0
    m, w = td.means[full], td.weights[full]
    nq = qs_t.shape[0]
    out = torch.zeros(bucket_capacity(nq), dtype=torch.float64, device=qs_t.device)
    if m.numel():
        mid = torch.cumsum(w, 0) - w * 0.5
        t = qs_t * w.sum()
        j = torch.searchsorted(mid, t)
        j0 = (j - 1).clamp(0, m.numel() - 1)
        j1 = j.clamp(0, m.numel() - 1)
        span = mid[j1] - mid[j0]
        frac = torch.where(span > 0, (t - mid[j0]) / span.clamp(min=1e-300), 0.0)
        est = m[j0] + (m[j1] - m[j0]) * frac.clamp(0.0, 1.0)
        est = torch.where(t <= mid[0], m[0], est)
        est = torch.where(t >= mid[-1], m[-1], est)
        out[:nq] = est.clamp(td.vmin, td.vmax)
    return Column(dtypes.float64, out, None, nq)


# =========================================================================
# HyperLogLog approximate distinct count
# =========================================================================

_HLL_P = 12  # 4096 registers, ~1.6% standard error


def hll_registers(cols: Sequence[Column]) -> torch.Tensor:
    """int32[2^12]: the register maxima of the rows' murmur3 hashes (a null
    hashes as its null code, so nulls count as one value)."""
    n = cols[0].length
    h = hashing.hash_columns(cols)[:n]
    idx = h >> (32 - _HLL_P)
    v = h & ((1 << (32 - _HLL_P)) - 1)
    bitlen = torch.zeros_like(v)
    for k in range(32 - _HLL_P):
        bitlen += (v >= (1 << k)).to(torch.int64)
    rank = (32 - _HLL_P + 1 - bitlen).to(torch.int32)
    regs = torch.zeros(1 << _HLL_P, dtype=torch.int32, device=h.device)
    return regs.scatter_reduce_(0, idx, rank, "amax", include_self=True)


def hll_estimate(regs: torch.Tensor) -> float:
    """The HLL estimate, with the small-range (linear counting) and
    large-range corrections."""
    r = regs.cpu().numpy().astype(np.float64)
    m = r.shape[0]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / np.sum(np.exp2(-r))
    zeros = float(np.sum(r == 0))
    if e <= 2.5 * m and zeros > 0:
        e = m * math.log(m / zeros)
    two32 = 2.0 ** 32
    if e > two32 / 30.0:
        e = -two32 * math.log1p(-e / two32)
    return e


def approx_distinct_count(cols: Sequence[Column]) -> int:
    """HLL approximate count of distinct rows (approx_distinct_count)."""
    return int(round(hll_estimate(hll_registers(cols))))


def hll_merge_registers(regsets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combine per-partition registers (the distributed merge: max)."""
    out = regsets[0]
    for r in regsets[1:]:
        out = torch.maximum(out, r)
    return out
