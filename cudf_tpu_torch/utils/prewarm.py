"""Ahead-of-use warm-up: the kernels built and the sort lane and scans warmed
per capacity bucket.

Counterpart of ``cudf_tpu/utils/prewarm.py`` (libcudf's JIT-cache preload,
cpp/src/jit/cache.cpp:26-50, cudf::initialize(INIT_JIT_CACHE)). The
reference compiles XLA executables for each capacity bucket. On a CUDA
card the work ahead of first use is different:

  1. every ``kernels/csrc/*.cu`` is compiled by nvcc (``kernels.build_all``),
     which a first launch would otherwise pay for (seconds);
  2. for each bucket, ``sort_by_key`` on an int64 and on an f64 key, a
     sort-lane groupby and the scans of ``ops/sortprim.py`` run once at
     that size, so the caching allocator, the library kernels' lazy
     loading and the lazy imports are paid before the first query.

``prewarm(n_rows)`` does this in a background thread by default, so a
pipeline's first queries overlap it. Unlike the reference, which swallows
every error as best effort, a failure raises: inline, or from the
thread's ``join``. It is idempotent per (device, bucket) in a process: a
bucket whose warm-up is still running is waited for, not taken as warm.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Union

import torch

# (device, bucket) -> the warm-up that warms it; a failed one is dropped,
# so a later call tries again
_warming: Dict[tuple, "PrewarmThread"] = {}
_lock = threading.Lock()


def _targets(cap: int, dev: torch.device):
    from ..core import dtypes
    from ..core.column import Column
    from ..core.table import Table
    from ..ops.groupby import AggSpec, groupby_aggregate
    from ..ops.sorting import sort_by_key
    from ..ops.sortprim import tiled_cumsum

    # a descending ramp, not zeros: on keys that agree in a digit the radix
    # sort skips that pass, and on all-equal keys it would launch, and so
    # load, none of its kernels
    k = torch.arange(cap, 0, -1, dtype=torch.int64, device=dev)
    f64 = k.to(torch.float64)
    tbl = Table({"k": Column(dtypes.int64, k, None, cap),
                 "v": Column(dtypes.float64, f64, None, cap)})
    # the engine's sort lane itself, not torch.sort alone: the order codes,
    # the gathers and the lazy imports around the sort are a first call's
    # cost too
    yield lambda: sort_by_key(tbl, ["k"])
    yield lambda: sort_by_key(tbl, ["v"])
    yield lambda: groupby_aggregate(tbl, ["k"], [AggSpec("v", "sum", "v")])
    yield lambda: tiled_cumsum(torch.ones(cap, dtype=torch.int32, device=dev))
    yield lambda: tiled_cumsum(f64)


def build_kernels() -> None:
    """Compile every CUDA source of ``kernels/csrc/`` not built yet."""
    from .. import kernels

    kernels.build_all(kernels.sources())


class PrewarmThread(threading.Thread):
    """A warm-up; ``join`` raises what it raised, or what an earlier
    warm-up it waits for raised."""

    def __init__(self, work, waits=()):
        super().__init__(name="cudf-tpu-torch-prewarm", daemon=True)
        self._work = work
        self._waits = list(waits)
        self.error: Optional[BaseException] = None

    def run(self):
        try:
            self._work()
            for th in self._waits:
                th.join()
        except Exception as e:  # kept for join(), which raises it
            self.error = e

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


def prewarm(n_rows: Union[Sequence[int], int], background: bool = True,
            extra_buckets: int = 1, device=None) -> Optional[PrewarmThread]:
    """Build the kernels (on a CUDA device) and warm the sort lane and scans
    for the buckets of ``n_rows`` and ``extra_buckets`` doublings of each.

    Returns the background thread, which also waits for any warm-up of
    these buckets still running; None when run inline or when every bucket
    was warmed before on this device."""
    from ..core.column import resolve_device
    from .padding import bucket_capacity

    dev = resolve_device(device)
    if isinstance(n_rows, int):
        n_rows = [n_rows]
    caps: List[int] = []
    with _lock:
        running = []
        for n in n_rows:
            c = bucket_capacity(max(int(n), 1))
            for _ in range(extra_buckets + 1):
                th = _warming.get((str(dev), c))
                if th is None:
                    caps.append(c)
                elif th.is_alive() and th not in running:
                    running.append(th)
                c *= 2
        if not caps and not running:
            return None

        def work():
            try:
                if dev.type == "cuda":
                    build_kernels()
                for cap in caps:
                    for t in _targets(cap, dev):
                        t()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception:
                with _lock:
                    for cap in caps:
                        _warming.pop((str(dev), cap), None)
                raise

        th = PrewarmThread(work, running)
        for cap in caps:
            _warming[(str(dev), cap)] = th
        th.start()
    if background:
        return th
    th.join()
    return None
