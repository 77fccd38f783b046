"""The readers of the program's inner ranges on hand-built traces (nesting,
and None where the trace holds no such range, as a program without the
ranges gives), and on the card, that every host-to-device copy of an
ingest is launched inside a ``host_to_device`` range inside
``Table.from_pandas``: the ranges share the device trace's clock."""
import pytest

from portbench.harness import cell, manifest as mf, spans as sp
from portbench.harness.trace import Trace

M = mf.load()
SPEC = mf.spec(M, "q1frame_sf30")
MS = 1_000_000  # ns


def _ctx(ranges=(), device=(), window=(0, 1000 * MS)):
    trace = Trace(window, sorted(ranges, key=lambda r: (r[1], -r[2])),
                  sorted(device, key=lambda d: d[1]))
    return cell.Context(SPEC, 0.0, trace.window_s, [], None, {}, trace)


def _read(name, ctx):
    return mf.metric_module(name).read(ctx)


NEW = ["ingest_host_share", "ingest_h2d_gbps", "join_host_reads", "join_rebuild_share",
       "compaction_share"]


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_programs_ranges(name):
    """The parent program's trace: the benchmark's own spans, a join with
    no inner ranges, aten ops and copies; and no trace at all."""
    ctx = _ctx([("portbench.from_pandas", 0, 500 * MS), ("join", 600 * MS, 700 * MS),
                ("aten::nonzero", 610 * MS, 620 * MS), ("groupby_aggregate", 800 * MS, 900 * MS)],
               [("Memcpy HtoD (Pageable -> Device)", 10 * MS, 400 * MS, 5 * MS)])
    assert _read(name, ctx) is None
    assert _read(name, cell.Context(SPEC, 0.0, 1.0, [], None, {}, None)) is None


def _ingests():
    """Two ingests of 300 ms and 200 ms; copies covering 100 + 50 ms of the
    first (one inside a column range, overlapping another) and 80 ms of the
    second; a nested Table.from_pandas counted once."""
    return [("Table.from_pandas", 0, 300 * MS),
            ("from_pandas.float64", 10 * MS, 200 * MS),
            ("host_to_device", 20 * MS, 100 * MS),
            ("host_to_device", 80 * MS, 120 * MS),
            ("from_pandas.category", 200 * MS, 299 * MS),
            ("host_to_device", 250 * MS, 300 * MS),
            ("Table.from_pandas", 400 * MS, 600 * MS),
            ("Table.from_pandas", 410 * MS, 590 * MS),
            ("host_to_device", 500 * MS, 580 * MS),
            ("host_to_device", 700 * MS, 800 * MS)]  # outside every ingest


def test_ingest_host_share_leaves_the_copies_out():
    # ingest 1: 300 - (20..120 = 100) - 50 = 150; ingest 2: 200 - 80 = 120
    assert _read("ingest_host_share", _ctx(_ingests())) == pytest.approx(100 * 270 / 1000)


def test_ingest_h2d_gbps_counts_the_copies_launched_inside():
    device = [("Memcpy HtoD (Pageable -> Device)", 30 * MS, 130 * MS, 25 * MS),
              ("Memcpy HtoD (Pageable -> Device)", 500 * MS, 560 * MS, 505 * MS),
              ("Memcpy HtoD (Pageable -> Device)", 700 * MS, 900 * MS, 705 * MS),  # outside
              ("Memcpy DtoD (Device -> Device)", 140 * MS, 190 * MS, 30 * MS),       # not HtoD
              ("Memcpy HtoD (Pageable -> Device)", 140 * MS, 190 * MS, None)]        # unlinked
    logical = mf.metric_module("peak_mem_ratio").logical_bytes(SPEC)
    got = _read("ingest_h2d_gbps", _ctx(_ingests(), device))
    assert got == pytest.approx(2 * logical / 1e9 / 0.160)


def test_join_host_reads_counts_reads_inside_outermost_joins():
    ranges = [("join", 0, 100 * MS), ("join", 10 * MS, 50 * MS),  # a nested join: one join
              ("host_read.fastjoin.n_build", 12 * MS, 13 * MS),
              ("hash_build", 14 * MS, 40 * MS),
              ("host_read.hashtable.pending", 15 * MS, 16 * MS),
              ("host_read.join.n_out", 60 * MS, 61 * MS),
              ("join", 200 * MS, 300 * MS),
              ("host_read.fastjoin.matched", 250 * MS, 251 * MS),
              ("host_read.join.conditional_hits", 400 * MS, 401 * MS)]  # outside a join
    assert _read("join_host_reads", _ctx(ranges)) == pytest.approx(4 / 2)


def test_join_rebuild_share_reads_every_round_but_the_last():
    ranges = [("join", 0, 500 * MS),
              ("hash_build", 10 * MS, 200 * MS),
              ("hash_build.round", 20 * MS, 50 * MS),
              ("hash_build.round", 50 * MS, 110 * MS),
              ("hash_build.round", 110 * MS, 190 * MS),
              ("hash_build", 300 * MS, 350 * MS),          # placed at its first size
              ("hash_build.round", 305 * MS, 340 * MS)]
    assert _read("join_rebuild_share", _ctx(ranges)) == pytest.approx(100 * 90 / 1000)
    one_round = [r for r in ranges if r[1] >= 300 * MS or r[0] == "join"]
    assert _read("join_rebuild_share", _ctx(one_round)) == 0.0


def test_compaction_share_reads_the_outermost_masks():
    ranges = [("apply_boolean_mask", 0, 100 * MS), ("apply_boolean_mask", 10 * MS, 20 * MS),
              ("join", 200 * MS, 400 * MS), ("apply_boolean_mask", 300 * MS, 350 * MS)]
    assert _read("compaction_share", _ctx(ranges)) == pytest.approx(100 * 150 / 1000)


def test_uncovered_time_clips_covers_to_the_span():
    assert sp.uncovered_ns((100, 200), []) == 100
    assert sp.uncovered_ns((100, 200), [(0, 50), (250, 300)]) == 100
    assert sp.uncovered_ns((100, 200), [(50, 120), (110, 150), (190, 260)]) == 40


@pytest.mark.cuda
def test_ingest_copies_launch_inside_host_to_device_inside_from_pandas():
    import numpy as np
    import pandas as pd
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the copies are the card's")
    import cudf_tpu_torch as ctt
    from portbench.harness import trace as tr

    n = 1 << 20
    host = pd.DataFrame({"q": np.arange(n, dtype=np.float64),
                         "f": pd.Categorical.from_codes(np.arange(n) % 3, ["A", "N", "R"]),
                         "d": (np.arange(n) * 86_400_000_000_000).view("datetime64[ns]")})
    ctt.from_pandas(host.head(8), device="cuda")  # the context and allocator up
    _, prof = tr.capture(lambda: ctt.from_pandas(host, device="cuda"))
    trace = tr.reduce(prof)
    ingests = tr.outermost(trace, "Table.from_pandas")
    assert len(ingests) == 1
    copies = sp.inside(trace, ingests, "host_to_device")[0]
    h2d = [d for d in trace.device if d[0].startswith("Memcpy HtoD")]
    assert len(h2d) >= 3
    for name, _, _, launch in h2d:
        assert launch is not None, name
        assert any(s <= launch <= e for s, e in copies), (name, launch, copies)
    assert 0 < mf.metric_module("ingest_h2d_gbps").read(
        cell.Context(SPEC, 0.0, trace.window_s, [], None, {}, trace))
