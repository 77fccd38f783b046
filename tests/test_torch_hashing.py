"""The port's murmur3 row hash (``cudf_tpu_torch/ops/hashing.py``) against
cudf_tpu's, bit for bit.

Columns of every key dtype, made from a seed with numpy, with nulls, NaN,
±0 and ±inf, go through both packages (the port on the CPU); the uint32
hashes must be equal exactly, one column at a time, several at once and
with a seed, through ``hash_values``, ``partition_ids`` and
``DataFrame.hash_values``. Rows equal under cuDF's row equality (null ==
null, NaN == NaN, -0 == +0) hash equal.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import hashing as rhash

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import hashing as thash

N = 1000


def _values(dtype, rng):
    if dtype in ("float32", "float64"):
        v = rng.normal(size=N).astype(dtype) * 1e3
        v[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0]
        v[8:20] = np.finfo(dtype).max * rng.choice([-1, 1], 12)
        v[20:30] = np.finfo(dtype).tiny * rng.integers(1, 5, 10)  # smallest normals
        return v
    if dtype == "bool":
        return rng.random(N) < 0.5
    if dtype == "str":
        return rng.choice(["", "a", "bb", "ccc", "a b"], N).astype(object)
    if dtype == "datetime64[ns]":
        return (pd.Timestamp("1960-01-01").value
                + rng.integers(0, 10**18, N)).astype("datetime64[ns]")
    if dtype == "timedelta64[ns]":
        return rng.integers(-10**15, 10**15, N).astype("timedelta64[ns]")
    if dtype == "category":
        return pd.Categorical(rng.choice(["lo", "mid", "hi"], N),
                              categories=["mid", "lo", "hi"])
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, N, dtype=dtype, endpoint=True)
    v[:3] = [info.min, info.max, 0]
    return v


DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float32", "float64", "bool", "str", "datetime64[ns]", "timedelta64[ns]",
          "category"]


def _frame(dtype, nulls, seed=0):
    rng = np.random.default_rng(seed)
    s = pd.Series(_values(dtype, rng))
    if nulls:
        mask = rng.random(N) < 0.1
        if dtype == "category" or s.dtype.kind in "OMm":
            s = s.where(~mask, None)
        elif s.dtype.kind == "f":
            s = pd.Series(pd.array(s.to_numpy(), dtype=f"Float{s.dtype.itemsize * 8}"))
            s[mask] = pd.NA
        elif s.dtype.kind == "b":
            s = pd.Series(pd.array(s.to_numpy(), dtype="boolean"))
            s[mask] = pd.NA
        else:
            name = ("UInt" if s.dtype.kind == "u" else "Int") + str(s.dtype.itemsize * 8)
            s = pd.Series(pd.array(s.to_numpy(), dtype=name))
            s[mask] = pd.NA
    return pd.DataFrame({"x": s})


def _both(pdf):
    return ct.Table.from_pandas(pdf), tt.Table.from_pandas(pdf, device="cpu")


def _u32(col, n):
    return np.asarray(col.to_numpy())[:n].astype(np.uint32)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_hash_values_bit_equal_to_reference(dtype, nulls):
    pdf = _frame(dtype, nulls)
    r, t = _both(pdf)
    got = thash.hash_values([t["x"]])
    assert got.dtype == tt.dtypes.uint32
    want = _u32(rhash.hash_values([r["x"]]), N)
    if dtype == "float32":
        # the reference's jitted hash folds its x + 0.0 away, so its f32 -0
        # hashes apart from +0 (its own equality words make them equal);
        # the port's -0 hashes as +0
        neg0 = np.flatnonzero(np.signbit(pdf["x"].to_numpy(np.float32, na_value=1.0))
                              & (pdf["x"].to_numpy(np.float32, na_value=1.0) == 0))
        assert len(neg0) and (want[neg0] != want[2]).all()
        want[neg0] = want[2]  # row 2 holds +0
    np.testing.assert_array_equal(_u32(got, N), want)
    for seed in (1, 0xDEADBEEF):
        np.testing.assert_array_equal(
            _u32(thash.hash_values([t["x"]], seed), N),
            np.asarray(rhash.hash_columns([r["x"]], seed))[:N].astype(np.uint32))


def test_seed_is_honoured():
    """The reference's ``hash_values`` drops its seed (its jitted body calls
    ``hash_columns`` without it); the port's seeds the hash as cuDF's
    hash_values(seed=) does, equal to the reference's ``hash_columns``."""
    r, t = _both(_frame("int64", True))
    np.testing.assert_array_equal(_u32(rhash.hash_values([r["x"]], 7), N),
                                  _u32(rhash.hash_values([r["x"]], 0), N))
    got = _u32(thash.hash_values([t["x"]], 7), N)
    assert (got != _u32(thash.hash_values([t["x"]], 0), N)).all()
    np.testing.assert_array_equal(
        got, np.asarray(rhash.hash_columns([r["x"]], 7))[:N].astype(np.uint32))


def test_equal_rows_hash_equal():
    """null == null whatever lies under it, NaN == NaN, -0 == +0."""
    pdf = pd.DataFrame({"f": pd.array([np.nan, -np.nan, 0.0, -0.0, None, None],
                                      dtype="Float64"),
                        "g": np.array([np.nan, -np.nan, 0.0, -0.0, 1.0, 1.0], np.float32)})
    t = tt.Table.from_pandas(pdf, device="cpu")
    h = _u32(thash.hash_values([t["g"]]), 6)
    assert h[0] == h[1] and h[2] == h[3]
    f = t["f"]
    f.data[4], f.data[5] = 5.0, 7.0  # payloads under the nulls differ
    h = _u32(thash.hash_values([f]), 6)
    assert h[2] == h[3] and h[4] == h[5]


def test_many_columns_partitions_and_frame_hash():
    cols = {d: _frame(d, d in ("int64", "str", "float64"), seed=i)["x"]
            for i, d in enumerate(["int64", "str", "float64", "uint64", "int16"])}
    pdf = pd.DataFrame(cols)
    r, t = _both(pdf)
    names = list(cols)
    np.testing.assert_array_equal(
        _u32(thash.hash_values([t[n] for n in names], 42), N),
        np.asarray(rhash.hash_columns([r[n] for n in names], 42))[:N].astype(np.uint32))
    for parts in (1, 7, 64):
        np.testing.assert_array_equal(
            thash.partition_ids([t[n] for n in names], parts)[:N].numpy(),
            np.asarray(rhash.partition_ids([r[n] for n in names], parts))[:N])
    got = tt.DataFrame.from_pandas(pdf, device="cpu").hash_values().to_pandas()
    want = ct.DataFrame.from_pandas(pdf).hash_values().to_pandas()
    np.testing.assert_array_equal(got.to_numpy().astype(np.uint32),
                                  want.to_numpy().astype(np.uint32))
