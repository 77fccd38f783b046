"""Tracing and profiling hooks.

Counterpart of ``cudf_tpu/utils/tracing.py`` (the reference's NVTX
plumbing: CUDF_FUNC_RANGE, cpp/include/cudf/detail/nvtx/ranges.hpp; the
python _performance_tracking decorator,
python/cudf/cudf/utils/performance_tracking.py:31). A range is a
``torch.profiler.record_function`` while a profiler records (with none it
opens none, the most of a range's host cost) and, when CUDA is up, an
NVTX range too. It never synchronizes but for the log below.

An operator sees the ranges three ways: as NVTX ranges under Nsight
Systems, in a ``torch.profiler`` trace of the CPU and CUDA activity (each
kernel linked to the launch inside the range that made it), or in the
chrome trace that ``profiler_trace`` writes. With the
``performance_tracking`` option on, each range also logs its wall time to
standard error as JSON (``op``, ``wall_s`` and the caller's fields);
``wall_s`` then ends after a synchronize of the current device, so it
holds the range's device work too.

The ranges, where each opens, and the benchmark metric that reads it
(``portbench/metrics/``):

- ``groupby_aggregate``, ``join``, ``sort_by_key``, ``DataFrame.merge``:
  ``trace_op`` on the engine's entry points. ``groupby_share`` and
  ``groupby_roofline`` read the first; ``join_share``, ``join_roofline``
  and ``join_host_reads`` the second;
- ``Table.from_pandas``: ``trace_op`` on ``core/table.py``'s ingest of one
  pandas frame, which every public pandas ingest reaches;
  ``ingest_host_share`` and ``ingest_h2d_gbps``;
- ``from_pandas.<pandas dtype>`` (``from_pandas.float64``,
  ``from_pandas.category``, ...): one column's conversion and copy inside
  it, so that a trace's idle gaps name the kind of column;
- ``host_to_device``: ``core/column.py:_pad_to``, the device fill and the
  host-to-device copy of one host array (ingest, un-spill, pack);
  ``ingest_host_share`` leaves its time out, ``ingest_h2d_gbps`` times the
  copies launched inside ``Table.from_pandas``;
- ``hash_build``: ``ops/fastjoin.py:build_hash_table``, one hash build of
  the join, and ``hash_build.round`` inside it around each build at one
  table size: on a card the one ``insert_table`` launch, on the CPU each
  ``build_table``; ``join_rebuild_share`` reads the rounds before the
  last;
- ``host_read.<site>``: each statement of ``ops/join.py``,
  ``ops/fastjoin.py`` and ``kernels/hashtable.py`` (``build_table``'s
  rounds, ``insert_table``) that waits for the card to hand the host a
  value (``host_read.join.n_out``, ``host_read.fastjoin.distinct``,
  ``host_read.hashtable.pending``, ``host_read.hashtable.counts`` — the
  insert's slots claimed and longest displacement, one read a build on
  a card —, ...); ``join_host_reads`` counts them inside ``join``;
- ``host_read.ingest.nulls``: ``core/column.py:_validity_of_marked``, the
  one read of whether any row is null in a column whose values mark
  their nulls (a categorical's code -1, a datetime64/timedelta64 NaT),
  whose null test runs on the device; one a column of that kind at
  ingest. No metric reads it (``join_host_reads`` counts only inside
  ``join``);
- ``apply_boolean_mask``: ``trace_op`` on
  ``ops/stream_compaction.py:apply_boolean_mask``, one compaction;
  ``compaction_share``;
- ``groupby.onehot``, ``groupby.dense``, ``groupby.sort``,
  ``groupby.wide``, ``groupby.generic``:
  ``ops/groupby.py:aggregate_in_memory``, each
  lane's attempt, a refused one (its plan check, or its call that
  returns None) too; ``groupby_generic_share`` reads the last;
- ``groupby.nunique``: ``ops/groupby.py:_nunique``, one per-group
  distinct count (its (keys, value) sort and the count of value runs), on
  the generic engine, the one lane that takes ``nunique``;
  ``nunique_share`` reads the device time launched inside it;
- ``join.semi``, ``join.anti``: ``ops/join.py:join``'s semi and anti
  joins, on whichever lane runs them (the hash lane's build and probe, or
  the general lane's sort), and their compaction. No metric reads them;
- ``groupby.corr``: the moments of a groupby's correlations
  (``ops/fastgroup.py:grouped_corr``), once a groupby, inside
  ``groupby.sort`` (``aggregate_sorted``) or ``groupby.generic``
  (``_aggregate_impl``). No metric reads it;
- ``groupby_head``: ``frame/groupby.py:DataFrameGroupBy.head``, the
  grouped row number and the compaction; ``groupby_head_share``;
- ``segment_reduce``: ``ops/sortprim.py:segment_reduce``, one per-segment
  reduction over key-sorted rows (the output's fill and the
  reduce-by-key kernel), inside whichever groupby lane called it;
  ``segreduce_device_share`` reads the device time launched inside it.
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
# whether a torch.profiler (or autograd profiler) records: a
# record_function costs ~10 us of host time even when none does
_PROFILING = torch._C._autograd._profiler_enabled


def _log(record: dict):
    print(json.dumps(record), file=sys.stderr, flush=True)


@contextmanager
def annotate(name: str, **meta):
    """A named range (profiler and NVTX) and, with ``performance_tracking``
    on, a log of its wall time, device work included."""
    tracking = get_option("performance_tracking")
    t0 = time.perf_counter() if tracking else 0.0
    nvtx = _NVTX and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if _PROFILING():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    if tracking:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the range's device work ends inside wall_s
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
