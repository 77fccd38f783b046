"""Launch-and-return check (counterpart of the Pallas kernel ``double`` in
``benchmarks/pallas_tunnel_repro.py``): ``o = x · 2`` over f32.

It is on no engine path. It shows that a kernel built from this repository
launches and returns on the card before anything larger runs. On a CUDA
tensor ``double`` launches ``csrc/launch_check.cu``; on a CPU tensor it
runs ``double_plain``.
"""
from __future__ import annotations

import torch

from . import KernelError, entry, on_device, stream_of


def double_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version."""
    return x * 2


def double(x: torch.Tensor) -> torch.Tensor:
    """f32[n] -> f32[n], each element times 2."""
    if x.dtype != torch.float32 or x.ndim != 1 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32[n], got {x.dtype}{list(x.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return double_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = entry("launch_check", "launch_check_double")
    with on_device(dev):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream_of(dev))
    if err != 0:
        raise KernelError(f"launch_check_double launch failed: CUDA error {err}")
    double.launches += 1
    return out


double.launches = 0  # kernel launches; chip_smoke.py reads it
