"""Multi-process execution of the port (``parallel/multihost.py``,
``parallel/multiproc_stream.py`` and ``spmd`` under a process group)
against cudf_tpu, after ``tests/test_multihost.py`` and
``tests/test_multiproc_stream.py``.

* In this process: ``execute_multiproc`` on the six cases of
  ``test_multiproc_stream.py`` through both packages (a single process
  runs ``execute_partitioned``), rtol 1e-12 for floats, a sort row for row.
* Two worker processes, the reference's two-ranks-one-machine fixture:
  each joins through ``multihost.initialize`` from the
  ``CUDF_TPU_COORDINATOR``/``CUDF_TPU_NUM_PROCESSES``/``CUDF_TPU_PROCESS_ID``
  variables (gloo, a ``TCPStore`` on a free port), builds an 8-shard
  ``global_mesh`` (4 CPU shards a process) and a ``ShardedTable`` with
  ``from_process_local``, runs ``dist_groupby``, ``dist_join`` (a string
  key whose dictionaries differ between the processes) and
  ``dist_sort_values`` across the processes against pandas, round-trips
  ``host_exchange`` (an empty partition, blobs of several 2 MB chunks, a
  spill store), and runs the six cases under ``execute_multiproc`` against
  the reference's single-process answers, which this process writes to
  parquet, and a groupby and a distinct that the lowering keeps in one
  partition against pandas. Each worker has a time limit.
* The NCCL check: two ranks on one card raise (no GPU needed).
"""
import inspect
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

from cudf_tpu.core.table import Table as RTable
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR
from cudf_tpu.expr.lowering import LoweringConfig as RConfig
from cudf_tpu.parallel.multiproc_stream import execute_multiproc as rexecute

import cudf_tpu_torch as tt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.expr.lowering import LoweringConfig as TConfig
from cudf_tpu_torch.parallel import multihost
from cudf_tpu_torch.parallel.multiproc_stream import execute_multiproc as texecute

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _drop_the_reference_traces():
    """The reference's jitted ops keep a string column's dictionary from
    their first trace (pinned in test_torch_lists.py): the traces made here
    are dropped when the module ends, so no later module decodes with them."""
    yield
    import jax

    jax.clear_caches()


def multiproc_cases(IR, E, Table, Config, kw):
    """test_multiproc_stream.py's six plans: name -> (plan, config)."""
    small = Config(target_partition_bytes=20_000, broadcast_limit_bytes=2_000)

    def df(n=5000, seed=0):
        rng = np.random.default_rng(seed)
        return pd.DataFrame({"k": rng.integers(0, 50, n), "g": rng.integers(0, 7, n),
                             "v": rng.normal(size=n), "w": rng.uniform(1, 2, n)})

    def scan(frame):
        return IR.DataFrameScan(Table.from_pandas(frame, **kw))

    col, lit = E.col, E.lit
    base = df()
    both_big = Config(target_partition_bytes=10_000, broadcast_limit_bytes=10)
    return {
        "groupby_via_shuffle": (IR.GroupBy(("k",), (E.NamedExpr("s", E.Agg(
            "sum", children=(col("v"),))),), children=(scan(base),)), small),
        "shuffle_join_both_big": (IR.Join(("k",), ("k",), "inner", children=(
            scan(df(4000, 1)[["k", "v"]]),
            scan(df(4000, 2).drop_duplicates("k")[["k", "w"]]))), both_big),
        "broadcast_join": (IR.Join(("k",), ("k",), "inner", children=(
            scan(base), scan(pd.DataFrame({"k": np.arange(50),
                                           "t": np.arange(50) * 2.0})))), small),
        "filter_select_pipeline": (IR.Select(
            (E.NamedExpr("k", col("k")),
             E.NamedExpr("vw", E.BinOp("mul", children=(col("v"), col("w"))))),
            children=(IR.Filter(E.BinOp("gt", children=(col("v"), lit(0.0))),
                                children=(scan(base),)),)), small),
        "sort_global_order": (IR.Sort(("v",), (False,), (True,),
                                      children=(scan(df(3000, 5)),)), small),
        "reduce_global": (IR.Reduce((E.NamedExpr("t", E.Agg("sum", children=(col("v"),))),),
                                    children=(scan(base),)), small),
    }


CASES = list(multiproc_cases(TIR, TE, tt.Table, TConfig, {"device": "cpu"}))


def check_case(name, got, want):
    """The port's answer of one case against the reference's."""
    if name == "reduce_global":
        assert np.isclose(float(got["t"].iloc[0]), float(want["t"].iloc[0]), rtol=1e-12)
        return
    assert list(got.columns) == list(want.columns), (list(got.columns), list(want.columns))
    if name == "sort_global_order":
        assert (np.diff(got["v"].to_numpy()) >= 0).all()
    else:
        cols = sorted(want.columns)
        got = got[cols].sort_values(cols, kind="stable").reset_index(drop=True)
        want = want[cols].sort_values(cols, kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True),
                                  check_dtype=False, rtol=1e-12)


@pytest.fixture(scope="module")
def reference_answers():
    plans = multiproc_cases(RIR, RE, RTable, RConfig, {})
    return {name: rexecute(plan, cfg, collect="global").to_pandas()
            for name, (plan, cfg) in plans.items()}


@pytest.mark.parametrize("name", CASES)
def test_single_process_multiproc_equals_the_reference(name, reference_answers):
    plan, cfg = multiproc_cases(TIR, TE, tt.Table, TConfig, {"device": "cpu"})[name]
    got = texecute(plan, cfg, collect="global", device="cpu").to_pandas()
    check_case(name, got, reference_answers[name])


def test_single_process_stays_single():
    """No address and no count: nothing is initialized, one process."""
    env = {k: os.environ.pop(k) for k in ("CUDF_TPU_COORDINATOR", "CUDF_TPU_NUM_PROCESSES",
                                          "CUDF_TPU_PROCESS_ID") if k in os.environ}
    try:
        multihost.initialize(device="cpu")
        assert multihost.process_count() == 1 and multihost.process_index() == 0
        t = tt.Table.from_pandas(pd.DataFrame({"x": [1, 2]}), device="cpu")
        assert multihost.host_exchange([t])[0] is t
    finally:
        os.environ.update(env)


def test_host_exchange_raises_when_a_blob_never_comes(monkeypatch):
    """A source that sends nothing: the exchange raises after
    ``timeout_ms``, it does not hang (one process posing as rank 0 of 2
    over a real ``TCPStore``)."""
    import datetime
    import time

    import torch.distributed as tdist

    store = tdist.TCPStore("127.0.0.1", _free_port(), 1, True, datetime.timedelta(seconds=30))
    monkeypatch.setattr(multihost._STATE, "store", store)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    t = tt.Table.from_pandas(pd.DataFrame({"x": [1, 2, 3]}), device="cpu")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"nothing from processes \[1\]"):
        multihost.host_exchange([t, t], timeout_ms=300)
    assert time.monotonic() - t0 < 10
    # what this rank sent to rank 1 is in the store, header last
    assert store.check([f"cudf_tpu_x/{multihost._STATE.epoch - 1}/0/1/hdr"])


def test_host_exchange_without_the_store_raises(monkeypatch):
    """A process group started without ``initialize`` has no store: the
    exchange raises instead of returning this rank's partition alone."""
    monkeypatch.setattr(multihost._STATE, "store", None)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    t = tt.Table.from_pandas(pd.DataFrame({"x": [1]}), device="cpu")
    with pytest.raises(RuntimeError, match="needs the store"):
        multihost.host_exchange([t, t])


def test_host_exchange_adds_its_seconds(monkeypatch):
    """``EXCHANGE_SECONDS`` sums each call's wall seconds, as the
    reference's does (a scaling run reads it per rank), a call that raises
    included."""
    import datetime

    import torch.distributed as tdist
    from cudf_tpu.parallel import multihost as rmultihost

    assert isinstance(rmultihost.EXCHANGE_SECONDS, float)
    monkeypatch.setattr(multihost, "EXCHANGE_SECONDS", 0.0)
    t = tt.Table.from_pandas(pd.DataFrame({"x": [1, 2, 3]}), device="cpu")
    assert multihost.host_exchange([t])[0] is t
    one = multihost.EXCHANGE_SECONDS
    assert one > 0.0
    store = tdist.TCPStore("127.0.0.1", _free_port(), 1, True, datetime.timedelta(seconds=30))
    monkeypatch.setattr(multihost._STATE, "store", store)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    with pytest.raises(TimeoutError):
        multihost.host_exchange([t, t], timeout_ms=300)
    assert multihost.EXCHANGE_SECONDS >= one + 0.3


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="would share the GPU"):
        multihost.check_one_rank_per_device(["box:0", "box:1", "box:0"])
    multihost.check_one_rank_per_device(["box:0", "box:1", "other:0"])


# ------------------------------------------------------------- two processes
_WORKER = """
import os, sys
import numpy as np, pandas as pd, torch

pid, nproc, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from cudf_tpu_torch.parallel import multihost, spmd
from cudf_tpu_torch.parallel.multiproc_stream import execute_multiproc
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops.groupby import AggSpec
import torch.distributed as tdist

multihost.initialize(device="cpu")          # from the CUDF_TPU_* variables
multihost.initialize(device="cpu")          # idempotent
assert multihost.process_count() == nproc and multihost.process_index() == pid
mesh = multihost.global_mesh(n_devices=4 * nproc, devices=["cpu"])
assert mesh.size == 4 * nproc and mesh.local_shards() == list(range(4 * pid, 4 * pid + 4))


def everyone(frame):
    got = [None] * nproc
    tdist.all_gather_object(got, frame)
    return pd.concat(got).reset_index(drop=True)


def local(df, parts):
    return [Table.from_pandas(df.iloc[parts[s]].reset_index(drop=True), device="cpu")
            for s in mesh.local_shards()]


rng = np.random.default_rng(0)
N = 4000
df = pd.DataFrame({"k": rng.integers(0, 37, N), "v": rng.normal(size=N)})
parts = np.array_split(np.arange(N), mesh.size)
st = spmd.ShardedTable.from_process_local(local(df, parts), mesh, cap=1024)
out = spmd.dist_groupby(st, ["k"], [AggSpec("v", "sum", "s"), AggSpec("v", "mean", "m")])
got = everyone(pd.concat([t.to_pandas() for t in out.local_tables()]))
want = df.groupby("k", as_index=False).agg(s=("v", "sum"), m=("v", "mean"))
pd.testing.assert_frame_equal(got.sort_values("k").reset_index(drop=True), want,
                              check_dtype=False, rtol=1e-12)
print(f"PROC{pid} GROUPBY OK", flush=True)

# a string key: each process's tables hold other strings, so other dictionaries
names = np.array([f"name_{i:03d}" for i in range(60)])
fact = pd.DataFrame({"k": names[rng.integers(0, 60, 3000)], "v": rng.normal(size=3000)})
dim = pd.DataFrame({"k": names[10:50][::-1].copy(), "w": np.arange(40) * 2.0})
fparts, dparts = np.array_split(np.arange(3000), mesh.size), np.array_split(np.arange(40), mesh.size)
sf = spmd.ShardedTable.from_process_local(local(fact, fparts), mesh)
sd = spmd.ShardedTable.from_process_local(local(dim, dparts), mesh)
joined = spmd.dist_join(sf, sd, ["k"], ["k"])
got = everyone(pd.concat([t.to_pandas() for t in joined.local_tables()]))
want = fact.merge(dim, on="k")
cols = ["k", "v", "w"]
pd.testing.assert_frame_equal(got[cols].sort_values(cols).reset_index(drop=True),
                              want[cols].sort_values(cols).reset_index(drop=True))
srt = spmd.dist_sort_values(st, ["v"], descending=True)
got = everyone(pd.concat([t.to_pandas() for t in srt.local_tables()]))
pd.testing.assert_frame_equal(got, df.sort_values("v", ascending=False, kind="stable")
                              .reset_index(drop=True))
print(f"PROC{pid} JOIN-SORT OK", flush=True)

# host_exchange: one partition to each process, one of them empty
parts2 = [Table.from_pandas(pd.DataFrame({"x": np.arange(0 if dest == 0 else 5)
                                          + 100 * pid + 10 * dest}), device="cpu")
          for dest in range(nproc)]
received = multihost.host_exchange(parts2, timeout_ms=60_000)
for src, t in enumerate(received):
    x = t.to_pandas()["x"].to_numpy()
    want = np.arange(0 if pid == 0 else 5) + 100 * src + 10 * pid
    assert len(x) == len(want) and (x == want).all(), (src, x)
# blobs of 3.2 MB: two chunks each, staged through a spill store
M = 400_000
big = [Table.from_pandas(pd.DataFrame({"y": np.full(M, 1000 * pid + dest, np.int64)}),
                         device="cpu") for dest in range(nproc)]
from cudf_tpu_torch.utils.native import PartitionStore
with PartitionStore(budget_bytes=1 << 20, spill_dir=os.path.join(out_dir, f"spill{pid}")) as store:
    recv2 = multihost.host_exchange(big, spill_store=store)
for src, t in enumerate(recv2):
    y = t.to_pandas()["y"].to_numpy()
    assert len(y) == M and (y == 1000 * src + pid).all(), (src, y[:3])
print(f"PROC{pid} EXCHANGE OK", flush=True)

from cudf_tpu_torch.expr import expressions as E, ir as IR
from cudf_tpu_torch.expr.lowering import LoweringConfig
CASES_SOURCE
for name, (plan, cfg) in multiproc_cases(IR, E, Table, LoweringConfig,
                                          {"device": "cpu"}).items():
    got = execute_multiproc(plan, cfg, collect="global", device="cpu").to_pandas()
    check_case(name, got, pd.read_parquet(os.path.join(out_dir, name + ".parquet")))
# the default config keeps this plan in one partition, so the lowering adds
# no Shuffle, but the scan splits its rows over the ranks: the groupby and
# distinct must still see every rank's rows (the reference groups each
# rank's rows apart and returns a key once a rank)
small = pd.DataFrame({"k": rng.integers(0, 9, 500), "v": rng.normal(size=500)})
scan = IR.DataFrameScan(Table.from_pandas(small, device="cpu"))
plan = IR.GroupBy(("k",), (E.NamedExpr("s", E.Agg("sum", children=(E.col("v"),))),),
                  children=(scan,))
got = execute_multiproc(plan, collect="global").to_pandas().sort_values("k")
want = small.groupby("k", as_index=False).agg(s=("v", "sum"))
pd.testing.assert_frame_equal(got.reset_index(drop=True), want, check_dtype=False, rtol=1e-12)
got = execute_multiproc(IR.Distinct(("k",), "first", children=(scan,)), collect="global")
assert sorted(got.to_pandas()["k"]) == sorted(small["k"].unique())
print(f"PROC{pid} MULTIPROC-STREAM OK", flush=True)
tdist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes(tmp_path, reference_answers):
    for name, frame in reference_answers.items():
        frame.to_parquet(tmp_path / f"{name}.parquet")
    source = textwrap.dedent(inspect.getsource(multiproc_cases)) + "\n" + \
        textwrap.dedent(inspect.getsource(check_case))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("CASES_SOURCE", source))
    port, nproc = _free_port(), 2
    procs = []
    for p in range(nproc):
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
            "PYTHONPATH", ""), CUDF_TPU_COORDINATOR=f"127.0.0.1:{port}",
            CUDF_TPU_NUM_PROCESSES=str(nproc), CUDF_TPU_PROCESS_ID=str(p))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(p), str(nproc), str(tmp_path)], cwd=str(ROOT),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for out, err, rc in outs:
        assert rc == 0, (rc, out[-2000:], err[-4000:])
        for stage in ("GROUPBY", "JOIN-SORT", "EXCHANGE", "MULTIPROC-STREAM"):
            assert f"{stage} OK" in out, (out, err[-4000:])
