"""The host partition store and bitmap codecs (``utils/native.py`` over
its own copy of ``native/partition_store.cpp``) against cudf_tpu's: the
cases of ``tests/test_native.py`` on the same seeded arrays, the store
behind spilled partitions, and a loader that raises when the build fails.
The tests skip only where there is no ``g++``."""
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from cudf_tpu.ops.groupby import AggSpec as RAgg
from cudf_tpu.parallel import partitioned as rpart
from cudf_tpu.utils import native as rnative

from cudf_tpu_torch.ops.groupby import AggSpec as TAgg
from cudf_tpu_torch.parallel import partitioned as tpart
from cudf_tpu_torch.utils import native


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the partition store")
    return native.load()


def test_put_get_roundtrip(lib, tmp_path):
    a = np.random.default_rng(0).normal(size=1000)
    with native.PartitionStore(budget_bytes=1 << 20, spill_dir=str(tmp_path)) as ps:
        pid = ps.put(a)
        np.testing.assert_array_equal(ps.get(pid), a)
        assert ps.get(pid).dtype == a.dtype


def test_lru_spill_and_unspill(lib, tmp_path):
    """A 1 MiB store holding five 0.5 MiB buffers spills the three least
    recently used to disk, as the reference's does, and reads them back."""
    arrays = [np.full(65536, i, np.float64) for i in range(5)]
    ref = rnative.PartitionStore(budget_bytes=1 << 20, spill_dir=str(tmp_path / "r"))
    with native.PartitionStore(budget_bytes=1 << 20, spill_dir=str(tmp_path / "t")) as ps:
        pids = [ps.put(a) for a in arrays]
        rpids = [ref.put(a) for a in arrays]
        st = ps.stats()
        assert st == ref.stats()
        assert st["spill_count"] >= 3 and st["resident_bytes"] <= 1 << 20
        assert len(list((tmp_path / "t").iterdir())) == st["spill_count"]
        for pid, rpid, a in zip(pids, rpids, arrays):
            np.testing.assert_array_equal(ps.get(pid), a)
            np.testing.assert_array_equal(ref.get(rpid), a)
        assert ps.stats()["unspill_count"] >= 3
        assert ps.stats() == ref.stats()


def test_drop(lib, tmp_path):
    with native.PartitionStore(budget_bytes=1 << 20, spill_dir=str(tmp_path)) as ps:
        pid = ps.put(np.arange(10))
        ps.drop(pid)
        assert ps._lib.ps_size(ps._h, pid) == -1
        assert ps.stats()["n_buffers"] == 0


def test_close_removes_its_own_spill_dir(lib):
    ps = native.PartitionStore(budget_bytes=0)
    ps.put(np.arange(100))  # spills at once: a zero budget
    d = ps.spill_dir
    assert ps.stats()["spill_count"] == 1 and os.listdir(d)
    ps.close()
    assert not os.path.exists(d)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000])
def test_pack_unpack_bits(lib, n):
    b = np.random.default_rng(n).random(n) < 0.5
    packed = native.pack_bits(b)
    np.testing.assert_array_equal(packed, rnative.pack_bits(b))
    np.testing.assert_array_equal(packed, np.packbits(b, bitorder="little"))
    np.testing.assert_array_equal(native.unpack_bits(packed, n), b)
    np.testing.assert_array_equal(native.unpack_bits(packed, n), rnative.unpack_bits(packed, n))


def test_loader_raises_on_a_broken_source(lib, tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return not_declared; }\n')
    with pytest.raises(RuntimeError, match="not_declared"):
        native.build(src)


def test_partitioned_frame_with_native_store(lib, tmp_path):
    """Spilled partitions live in a 200 KB store, which spills to disk; the
    groupby over them equals the reference's and pandas'."""
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"k": rng.integers(0, 8, 20000), "v": rng.normal(size=20000)})
    want = df.groupby("k", as_index=False).agg(s=("v", "sum"))
    rstore = rnative.PartitionStore(budget_bytes=200_000, spill_dir=str(tmp_path / "r"))
    rpart.set_partition_store(rstore)
    try:
        ref = rpart.PartitionedFrame.from_pandas(df, npartitions=6).groupby_agg(
            ["k"], [RAgg("v", "sum", "s")]).to_pandas()
    finally:
        rpart.set_partition_store(None)
    with native.PartitionStore(budget_bytes=200_000, spill_dir=str(tmp_path / "t")) as store:
        tpart.set_partition_store(store)
        try:
            pf = tpart.PartitionedFrame.from_pandas(df, npartitions=6, device="cpu")
            assert store.stats()["spill_count"] > 0
            assert all(p.store is store for p in pf._parts)
            got = pf.groupby_agg(["k"], [TAgg("v", "sum", "s")]).to_pandas()
            assert store.stats()["unspill_count"] > 0
            n_buffers = store.stats()["n_buffers"]
            del pf
            assert store.stats()["n_buffers"] < n_buffers  # a dropped frame frees its buffers
        finally:
            tpart.set_partition_store(None)
    pd.testing.assert_frame_equal(got, ref, rtol=1e-12)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
