"""Launch-and-return check (counterpart of the Pallas kernel ``double`` in
``benchmarks/pallas_tunnel_repro.py``): ``o = x · 2`` over f32.

It is on no engine path. It shows that a kernel built from this repository
launches and returns on the card before anything larger runs. On a CUDA
tensor ``double`` launches ``csrc/launch_check.cu``; on a CPU tensor it
runs ``double_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import load_library


def double_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version."""
    return x * 2


def double(x: torch.Tensor) -> torch.Tensor:
    """f32[n] -> f32[n], each element times 2."""
    if x.dtype != torch.float32 or x.ndim != 1 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32[n], got {x.dtype}{list(x.shape)}")
    if x.device.type == "cpu":
        return double_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = load_library("launch_check").launch_check_double
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_check_double launch failed: CUDA error {err}")
    double.launches += 1
    return out


double.launches = 0  # kernel launches; chip_smoke.py reads it
