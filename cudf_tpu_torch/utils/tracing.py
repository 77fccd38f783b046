"""Tracing and profiling hooks.

Counterpart of ``cudf_tpu/utils/tracing.py`` (the reference's NVTX
plumbing: CUDF_FUNC_RANGE, cpp/include/cudf/detail/nvtx/ranges.hpp; the
python _performance_tracking decorator,
python/cudf/cudf/utils/performance_tracking.py:31). A range is a
``torch.profiler.record_function`` (it shows in a torch.profiler trace)
and, when CUDA is up, an NVTX range too; host wall times go to a
structured log on standard error when the ``performance_tracking``
option is on. The engine's entry points carry one (``trace_op``):
``ops.groupby.groupby_aggregate``, ``ops.join.join``,
``ops.sorting.sort_by_key`` and ``frame.DataFrame.merge``.
"""
from __future__ import annotations

import functools
import json
import sys
import time
from contextlib import contextmanager

import torch

from .options import get_option

# torch built without NVTX stubs torch.cuda.nvtx with functions that raise
_NVTX = hasattr(torch._C, "_nvtx")


def _log(record: dict):
    print(json.dumps(record), file=sys.stderr, flush=True)


@contextmanager
def annotate(name: str, **meta):
    """A named range (profiler and NVTX) and an optional wall-clock log."""
    tracking = get_option("performance_tracking")
    t0 = time.perf_counter() if tracking else 0.0
    nvtx = _NVTX and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    if tracking:
        _log({"op": name, "wall_s": round(time.perf_counter() - t0, 6), **meta})


def trace_op(fn):
    """Decorator version of annotate for operator entry points."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with annotate(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


def profiler_trace(log_dir: str):
    """Start a torch.profiler trace of the CPU and, when there is one, the
    card; the returned function stops it and writes a chrome trace under
    ``log_dir`` (view with TensorBoard or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof.stop
