"""The device-memory budget (``utils/hbm.py``) against cudf_tpu's: the
cases of ``tests/test_hbm.py``, each run on the same seeded frames through
both packages' ``PartitionedFrame`` under a 256 KiB budget (the port on the
CPU), with the same admission, eviction and answers."""
import gc

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.ops.groupby import AggSpec as RAgg
from cudf_tpu.parallel.partitioned import PartitionedFrame as RPF
from cudf_tpu.utils import hbm as rhbm

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops.groupby import AggSpec as TAgg
from cudf_tpu_torch.parallel.partitioned import PartitionedFrame as TPF
from cudf_tpu_torch.utils import hbm as thbm

BUDGET = 256 * 1024


@pytest.fixture
def budgets():
    pair = (rhbm.HbmBudget(BUDGET), thbm.HbmBudget(BUDGET))
    rhbm.set_hbm_budget(pair[0])
    thbm.set_hbm_budget(pair[1])
    yield pair
    rhbm.set_hbm_budget(None)
    thbm.set_hbm_budget(None)


def _frame(rows=40_000, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 50, rows), "v": rng.normal(size=rows)})


def _frames(n_parts=8, rows=40_000):
    df = _frame(rows)
    return df, RPF.from_pandas(df, n_parts), TPF.from_pandas(df, n_parts, device="cpu")


def test_admission_keeps_used_under_budget(budgets):
    rb, tb = budgets
    _, rpf, tpf = _frames()
    for rp, tp in zip(rpf._parts, tpf._parts):
        rp.get()
        tp.get()
    for b in (rb, tb):
        assert b.used <= b.budget
        assert b.stats()["spill_count"] > 0
    assert tb.stats()["resident"] == rb.stats()["resident"]
    assert tb.spill_count == rb.spill_count


def test_results_correct_under_eviction(budgets):
    rb, tb = budgets
    df, rpf, tpf = _frames()
    want = df.groupby("k", as_index=False).agg(s=("v", "sum"))
    ref = rpf.groupby_agg(["k"], [RAgg("v", "sum", "s")]).to_pandas()
    got = tpf.groupby_agg(["k"], [TAgg("v", "sum", "s")]).to_pandas()
    pd.testing.assert_frame_equal(got, ref, rtol=1e-12)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    assert tb.used <= tb.budget and tb.spill_count > 0


def test_touch_moves_to_mru(budgets):
    _, tb = budgets
    _, _, tpf = _frames(n_parts=4)
    first = tpf._parts[0]
    first.get()
    for p in tpf._parts[1:]:
        p.get()
        first.get()  # keep partition 0 the most recently used
    assert first.table is not None and id(first) in tb._live
    assert list(tb._live)[-1] == id(first)


def test_release_on_frame_drop(budgets):
    rb, tb = budgets
    _, rpf, tpf = _frames(n_parts=2)
    for rp, tp in zip(rpf._parts, tpf._parts):
        rp.get()
        tp.get()
    assert rb.used > 0 and tb.used > 0
    del rpf, tpf, rp, tp
    gc.collect()
    assert rb.used == 0 and tb.used == 0


def test_partition_outliving_its_frame_stays_counted(budgets):
    """A partition still referenced after its frame goes keeps its table on
    the device. The reference's ``PartitionedFrame.__del__`` releases it
    from the budget anyway (a fault: its budget reads 0); the port releases
    a partition only when the partition itself is collected."""
    rb, tb = budgets
    _, rpf, tpf = _frames(n_parts=2)
    rkeep, tkeep = rpf._parts[-1], tpf._parts[-1]
    for rp, tp in zip(rpf._parts, tpf._parts):
        rp.get()
        tp.get()
    del rpf, tpf, rp, tp
    gc.collect()
    assert rkeep.table is not None and tkeep.table is not None
    assert rb.used == 0
    assert tb.used == tb._live[id(tkeep)][0] == thbm.table_device_bytes(tkeep.table) > 0
    del tkeep
    gc.collect()
    assert tb.used == 0


def test_oversized_single_partition_admitted(budgets):
    df = pd.DataFrame({"v": np.random.default_rng(1).normal(size=200_000)})  # 1.6 MB
    ref = RPF.from_pandas(df, 1)._parts[0].get()
    got = TPF.from_pandas(df, 1, device="cpu")._parts[0].get()
    assert got.num_rows == ref.num_rows == len(df)
    np.testing.assert_array_equal(got["v"].to_numpy(), df["v"].to_numpy())


def test_env_bootstrap(monkeypatch):
    thbm.set_hbm_budget(None)
    rhbm.set_hbm_budget(None)
    monkeypatch.setenv("CUDF_TPU_HBM_BUDGET", "2e6")
    try:
        got, ref = thbm.get_hbm_budget(), rhbm.get_hbm_budget()
        assert got is not None and got.budget == ref.budget == 2_000_000
    finally:
        thbm.set_hbm_budget(None)
        rhbm.set_hbm_budget(None)


def test_table_device_bytes_reads_the_tensors():
    """Each buffer's own nbytes, padding rows and validity masks included
    (the reference estimates from capacity and dtype: the same bytes here)."""
    df = pd.DataFrame({"a": pd.array([1, None, 3], dtype="Int32"),
                       "b": np.array([1.0, 2.0, 3.0], np.float32)})
    t = tt.Table.from_pandas(df, device="cpu")
    want = sum(c.data.nbytes + (0 if c.validity is None else c.validity.nbytes)
               for _, c in t)
    assert thbm.table_device_bytes(t) == want == 128 * (4 + 1 + 4)
    assert rhbm.table_device_bytes(ct.Table.from_pandas(df)) == want
    assert t["a"].validity.dtype == torch.bool
