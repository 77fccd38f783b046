"""The port's options registry, tracing hooks and prewarm
(``utils/options.py``, ``utils/tracing.py``, ``utils/prewarm.py``) against
cudf_tpu's where the two share a contract, and the port's own rules where
they differ: a warm-up failure raises (the reference swallows it), and a
warm-up on the CPU builds nothing.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from cudf_tpu.utils import options as RO
from cudf_tpu.utils import prewarm as RP

import cudf_tpu_torch as ctt
from cudf_tpu_torch import kernels
from cudf_tpu_torch.utils import options as TO
from cudf_tpu_torch.utils import prewarm as TP
from cudf_tpu_torch.utils import tracing as TT

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _drop_the_reference_traces():
    """A jitted op of the reference returns the dictionary of its first
    trace (pinned in test_torch_lists.py): the traces made here are dropped
    when the module ends, so no later module decodes with its dictionaries."""
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- options
def test_options_equal_the_reference():
    """The port registers the reference's options that its code reads, under
    the same names, defaults and descriptions, and no other."""
    ref = RO.describe_options()
    assert set(TO.describe_options()) == {"performance_tracking"}
    for name, text in TO.describe_options().items():
        assert text == ref[name]
        assert TO.get_option(name) == RO.get_option(name)


ENV_CASES = [("yes", True), ("1", True), ("TRUE", True), ("off", False)]


@pytest.mark.parametrize("raw,want", ENV_CASES, ids=[c[0] for c in ENV_CASES])
def test_env_defaults(raw, want):
    code = ("from cudf_tpu_torch.utils.options import get_option\n"
            "print(repr(get_option('performance_tracking')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO,
                       env=dict(os.environ, CUDF_TPU_PERFORMANCE_TRACKING=raw))
    assert r.stdout.strip() == repr(want), r.stderr[-2000:]


@pytest.mark.parametrize("bad", [1, 0, "yes", None, 2.5])
def test_set_option_validates(bad):
    with pytest.raises(ValueError, match="invalid value"):
        TO.set_option("performance_tracking", bad)
    with pytest.raises(ValueError, match="invalid value"):
        RO.set_option("performance_tracking", bad)


@pytest.mark.parametrize("name", ["spill", "target_partition_rows", "broadcast_limit_rows",
                                  "default_float_bitwidth", "shuffle_bucket_factor"])
def test_an_option_nothing_reads_is_not_registered(name):
    RO.get_option(name)
    with pytest.raises(KeyError):
        TO.get_option(name)


def test_option_context_restores():
    assert TO.get_option("performance_tracking") is False
    with TO.option_context("performance_tracking", True):
        assert TO.get_option("performance_tracking") is True
    assert TO.get_option("performance_tracking") is False
    with pytest.raises(RuntimeError):
        with TO.option_context("performance_tracking", True):
            raise RuntimeError("inside")
    assert TO.get_option("performance_tracking") is False
    with pytest.raises(KeyError):
        TO.get_option("no_such_option")


# ----------------------------------------------------------------- tracing
def test_annotate_records_on_a_cpu_profiler_trace():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TT.annotate("port.op"):
            torch.ones(64).sum()
        TT.trace_op(lambda: torch.zeros(8).sum())()
    names = {e.key for e in prof.key_averages()}
    assert "port.op" in names
    assert any(n.endswith("<lambda>") for n in names)


def test_the_engine_entry_points_record_their_ranges(capsys):
    """groupby, join, sort and the frame's merge each open a range on a
    profiler trace, and log a line with ``performance_tracking`` on."""
    import pandas as pd

    from cudf_tpu_torch import DataFrame
    from cudf_tpu_torch.ops.groupby import AggSpec, groupby_aggregate
    from cudf_tpu_torch.ops.sorting import sort_by_key

    df = DataFrame.from_pandas(pd.DataFrame({"k": [2, 1, 2], "v": [1.0, 2.0, 3.0]}),
                               device="cpu")
    other = DataFrame.from_pandas(pd.DataFrame({"k": [1, 2], "w": [5.0, 6.0]}),
                                  device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TO.option_context("performance_tracking", True):
            groupby_aggregate(df._tbl, ["k"], [AggSpec("v", "sum", "v")])
            sort_by_key(df._tbl, ["k"])
            df.merge(other, on="k")
    want = {"groupby_aggregate", "sort_by_key", "join", "DataFrame.merge"}
    assert want <= {e.key for e in prof.key_averages()}
    logged = {json.loads(line)["op"] for line in capsys.readouterr().err.splitlines()}
    assert want <= logged


def test_log_keeps_the_reference_fields(capsys):
    with TO.option_context("performance_tracking", True):
        with TT.annotate("groupby", rows=10):
            pass
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(rec) == {"op", "wall_s", "rows"} and rec["op"] == "groupby"
    assert rec["rows"] == 10 and rec["wall_s"] >= 0
    with TT.annotate("quiet"):
        pass
    assert capsys.readouterr().err == ""  # no log with tracking off


def test_profiler_trace_writes_under_log_dir(tmp_path):
    stop = TT.profiler_trace(str(tmp_path))
    with TT.annotate("traced"):
        torch.arange(16).sum()
    stop()
    traces = list(tmp_path.glob("*.json"))
    assert traces and "traced" in traces[0].read_text()


# ----------------------------------------------------------------- prewarm
@pytest.fixture
def fresh_prewarm(monkeypatch):
    monkeypatch.setattr(TP, "_warming", {})
    monkeypatch.setattr(RP, "_started", set())


def test_prewarm_on_the_cpu_builds_nothing(monkeypatch, fresh_prewarm):
    def no_build(names):
        raise AssertionError("a CPU warm-up must not call nvcc")

    monkeypatch.setattr(kernels, "build_all", no_build)
    warmed = []
    inner = TP._targets
    monkeypatch.setattr(TP, "_targets", lambda cap, dev: (
        warmed.append((cap, dev.type)) or inner(cap, dev)))
    assert ctt.prewarm(1000, background=False, device="cpu") is None
    assert warmed == [(1024, "cpu"), (2048, "cpu")]


def test_prewarm_is_idempotent_per_bucket(monkeypatch, fresh_prewarm):
    warmed = []
    inner = TP._targets
    monkeypatch.setattr(TP, "_targets", lambda cap, dev: warmed.append(cap) or inner(cap, dev))
    th = TP.prewarm([1000, 3000], device="cpu")
    th.join(timeout=120)
    assert not th.is_alive()
    assert sorted(warmed) == [1024, 2048, 4096, 8192]
    assert TP.prewarm(2000, device="cpu") is None  # 2048 and 4096 warmed already
    assert TP.prewarm(5000, background=False, device="cpu") is None
    assert sorted(warmed) == [1024, 2048, 4096, 8192, 16384]


def test_a_bucket_still_warming_is_waited_for(monkeypatch, fresh_prewarm):
    """A second call while the first warm-up still runs gets a thread that
    waits for it, and raises what it raised."""
    import threading

    gate = threading.Event()

    def slow_targets(cap, dev=None):
        def step():
            gate.wait(60)
            raise RuntimeError(f"warm-up failed at {cap}")

        yield step

    monkeypatch.setattr(TP, "_targets", slow_targets)
    first = TP.prewarm(1000, device="cpu", extra_buckets=0)
    second = TP.prewarm(1000, device="cpu", extra_buckets=0)
    assert second is not None and second is not first
    assert second.is_alive()
    gate.set()
    for th in (first, second):
        with pytest.raises(RuntimeError, match="warm-up failed at 1024"):
            th.join(timeout=120)
    assert TP._warming == {}  # failed: not warm, a later call tries again


def _failing_targets(cap, dev=None):
    def fail():
        raise RuntimeError(f"warm-up failed at {cap}")

    yield fail


def test_a_failing_target_raises_inline_and_through_the_thread(monkeypatch, fresh_prewarm):
    monkeypatch.setattr(TP, "_targets", _failing_targets)
    with pytest.raises(RuntimeError, match="warm-up failed at 1024"):
        TP.prewarm(1000, background=False, device="cpu", extra_buckets=0)
    th = TP.prewarm(5000, device="cpu", extra_buckets=0)
    with pytest.raises(RuntimeError, match="warm-up failed at 8192"):
        th.join(timeout=120)
    # a failed bucket is not marked warm
    with pytest.raises(RuntimeError, match="warm-up failed at 1024"):
        TP.prewarm(1000, background=False, device="cpu", extra_buckets=0)


def test_reference_swallows_a_failing_target(monkeypatch, fresh_prewarm):
    """Pinned: the reference's warm-up is best effort, and a failure
    vanishes."""
    monkeypatch.setattr(RP, "_targets", _failing_targets)
    assert RP.prewarm(1000, background=False, extra_buckets=0) is None
    th = RP.prewarm(5000, extra_buckets=0)
    th.join(timeout=120)
    assert not th.is_alive()


def test_a_failing_kernel_build_raises(monkeypatch, tmp_path):
    """Without nvcc (this machine) or with a source that does not compile,
    building the kernels raises a KernelError; nothing is swallowed."""
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvcc on it
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(kernels.KernelError):
        TP.build_kernels()
