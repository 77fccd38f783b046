"""The reader of the program's ``segment_reduce`` ranges
(``segreduce_device_share``) on hand-built traces: the device time
launched inside the outermost ranges, and None where the trace holds no
such range, as a program without them gives, or no device operation, as a
run on the CPU gives."""
import pytest

from portbench.harness import cell, manifest as mf
from portbench.harness.trace import Trace

M = mf.load()
SPEC = mf.spec(M, "h2o_g1_1e8")
MS = 1_000_000  # ns
NAME = "segreduce_device_share"


def _ctx(ranges=(), device=(), window=(0, 1000 * MS)):
    trace = Trace(window, sorted(ranges, key=lambda r: (r[1], -r[2])),
                  sorted(device, key=lambda d: d[1]))
    return cell.Context(SPEC, 0.0, trace.window_s, [], None, {}, trace)


def _read(ctx):
    return mf.metric_module(NAME).read(ctx)


def test_the_metric_is_the_h2o_cells_and_moves_its_p95():
    (m,) = [m for m in M["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["h2o_g1_1e8.questions"] and m["moves"] == "query_p95_ms"
    assert m["layer"] == "Kernels of the groupby" and m["source"] == "device_trace"


def test_none_without_the_programs_ranges_or_a_device():
    """The parent program's trace (a generic groupby whose reductions open no
    range, a scatter kernel launched inside it); a CPU trace with the ranges
    but no device operation; no trace at all."""
    scatter = [("_scatter_gather_elementwise_kernel", 100 * MS, 400 * MS, 20 * MS)]
    parent = [("groupby_aggregate", 0, 500 * MS), ("groupby.generic", 10 * MS, 90 * MS)]
    assert _read(_ctx(parent, scatter)) is None
    assert _read(_ctx(parent + [("segment_reduce", 20 * MS, 30 * MS)])) is None
    assert _read(cell.Context(SPEC, 0.0, 1.0, [], None, {}, None)) is None


def test_counts_the_device_time_launched_inside_outermost_ranges():
    ranges = [("groupby.generic", 0, 400 * MS),
              ("segment_reduce", 10 * MS, 20 * MS),
              ("segment_reduce", 12 * MS, 15 * MS),   # nested: one range
              ("segment_reduce", 30 * MS, 40 * MS),
              ("aten::sort", 50 * MS, 60 * MS)]
    device = [("FillFunctor", 100 * MS, 101 * MS, 11 * MS),
              ("reduce_tiles", 101 * MS, 103 * MS, 13 * MS),     # in the nested range
              ("reduce_tiles", 103 * MS, 110 * MS, 35 * MS),
              ("DeviceRadixSortOnesweepKernel", 110 * MS, 300 * MS, 55 * MS),  # outside
              ("reduce_tiles", 300 * MS, 305 * MS, None)]        # unlinked
    assert _read(_ctx(ranges, device)) == pytest.approx(100 * 10 / 1000)
