"""Single-pass low-cardinality groupby sum/count (counterpart of
``cudf_tpu/kernels/onehot_groupby.py``).

``groupby_sum_count`` returns f64 [K, V+1]: per group k,
``sum w·(w·vals[:, j])`` for each value column j and ``sum w·w`` last —
the function of the reference's weighted one-hot matmul, where the weight
enters both factors. Rows whose gid lies outside [0, K) contribute nothing.

On a CUDA tensor it launches the hand-written kernel
(``csrc/onehot_groupby.cu``: f32 accumulation per tile, f64 across tiles,
so counts are exact at any group size; the same bits on every run). The
wrapper picks its tier from K·(V+1) (``_tier``): registers up to
``REG_SLOTS`` accumulators, else per-warp copies in shared memory. On a CPU
tensor it runs ``groupby_sum_count_plain``, the same function in plain
PyTorch, which is also the kernel's oracle.
"""
from __future__ import annotations

import ctypes

import torch

from . import KernelError, entry, on_device, stream_of

MAX_GROUPS = 2048            # the lane's bound: 2^tbits with tbits <= 11
REG_SLOTS = 32               # register tier: K·(V+1) accumulators a thread holds
_SMEM_BYTES = 227 * 1024     # a block's shared memory on the H100, after opt-in
_WARPS = 8                   # warps of a shared-tier block where they fit


def groupby_sum_count_plain(gid: torch.Tensor, vals: torch.Tensor,
                            weight: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into f64, out-of-range gids
    sent to an overflow row that is cut off."""
    K = n_groups
    w = weight.to(torch.float32)[:, None]
    contrib = torch.cat([(vals.to(torch.float32) * w) * w, w * w], 1)
    ok = (gid >= 0) & (gid < K)
    idx = torch.where(ok, gid.to(torch.int64), K)
    out = torch.zeros((K + 1, contrib.shape[1]), dtype=torch.float64,
                      device=gid.device)
    out.index_add_(0, idx, contrib.to(torch.float64))
    return out[:K]


def _check(gid, vals, weight, n_groups):
    dev = gid.device
    if vals.device != dev or weight.device != dev:
        raise ValueError(f"tensors on different devices: {gid.device}, "
                         f"{vals.device}, {weight.device}")
    if gid.dtype != torch.int32 or gid.ndim != 1:
        raise TypeError(f"gid must be int32[N], got {gid.dtype}{list(gid.shape)}")
    if vals.dtype != torch.float32 or vals.ndim != 2 or vals.shape[0] != gid.shape[0]:
        raise TypeError(f"vals must be float32[N, V], got {vals.dtype}{list(vals.shape)}")
    if weight.dtype != torch.float32 or weight.shape != gid.shape:
        raise TypeError(f"weight must be float32[N], got {weight.dtype}{list(weight.shape)}")
    if not (gid.is_contiguous() and vals.is_contiguous() and weight.is_contiguous()):
        raise ValueError("gid, vals and weight must be contiguous")
    if not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(f"n_groups must be in [1, {MAX_GROUPS}], got {n_groups}")
    _tier(n_groups, vals.shape[1])


def _tier(n_groups: int, V: int) -> int:
    """0 for the register tier, else the warps of a shared-tier block: each
    warp holds an f32 copy of the [K, V+1] accumulator beside the block's
    f64 total, S·8 + warps·S·4 bytes for S = K·(V+1). Raises when not even
    one warp's copy fits."""
    S = n_groups * (V + 1)
    if S <= REG_SLOTS:
        return 0
    warps = min(_WARPS, (_SMEM_BYTES // S - 8) // 4)
    if warps < 1:
        raise ValueError(f"[{n_groups}, {V + 1}] accumulator exceeds a block's "
                         "shared memory")
    return warps


def groupby_sum_count(gid: torch.Tensor, vals: torch.Tensor, weight: torch.Tensor,
                      n_groups: int) -> torch.Tensor:
    """f64 [K, V+1]: per-group weighted sums of each value column, then the
    weight total (the count for 0/1 weights). gid i32[N], vals f32[N, V],
    weight f32[N]."""
    if gid.device.type == "cpu" and vals.device.type == "cpu" \
            and weight.device.type == "cpu":
        return groupby_sum_count_plain(gid, vals, weight, n_groups)
    _check(gid, vals, weight, n_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"no kernel for device {gid.device}")
    V = vals.shape[1]
    n = gid.shape[0]
    if n == 0:
        return torch.zeros((n_groups, V + 1), dtype=torch.float64, device=gid.device)
    warps = _tier(n_groups, V)
    grid = entry("onehot_groupby", "onehot_groupby_blocks")
    fn = entry("onehot_groupby", "onehot_groupby_sum_count")
    out = torch.empty((n_groups, V + 1), dtype=torch.float64, device=gid.device)
    blocks = ctypes.c_int(0)
    with on_device(gid.device):
        err = grid(n, V, n_groups, warps, ctypes.byref(blocks))
        if err == 0:
            partials = torch.empty(blocks.value * n_groups * (V + 1), dtype=torch.float64,
                                   device=gid.device)
            err = fn(gid.data_ptr(), vals.data_ptr(), weight.data_ptr(),
                     partials.data_ptr(), out.data_ptr(), n, V, n_groups, warps,
                     blocks.value, stream_of(gid.device))
    if err != 0:
        raise KernelError(f"onehot_groupby_sum_count launch failed: CUDA error {err}")
    groupby_sum_count.launches += 1
    return out


groupby_sum_count.launches = 0  # kernel launches; chip_smoke.py reads it


def groupby_low_cardinality(gid, vals_list, valid_list, n_groups: int):
    """sum + count per group for each value column; dense gid in [0, K);
    one shared validity (``valid_list[0]``) weights every column."""
    vals = torch.stack([v.to(torch.float32) for v in vals_list], 1)
    out = groupby_sum_count(gid.to(torch.int32).contiguous(), vals,
                            valid_list[0].to(torch.float32), n_groups)
    V = len(vals_list)
    return [out[:, j] for j in range(V)], out[:, V]
