"""Ingest of the columns whose values mark their own nulls: a pandas
categorical (code -1) and a datetime64/timedelta64 column (NaT).

Such a column crosses to the device as pandas holds it, and the null test,
the widening of the codes and the zeroing of null codes run there
(``core/categorical.py:from_codes``, ``core/table.py:_column_from_pandas``).
Each case holds ``Table.from_pandas(..., device="cpu")`` against a plain
numpy copy of the host conversion that did all of this before, bit for bit
(data, capacity, validity or ``None``, padding, dictionary, order flag,
length), and its ``to_pandas`` against ``cudf_tpu``'s and pandas'. On the
card, the same frames ingest to the same tensors as on the CPU.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct

from cudf_tpu_torch import Table
from cudf_tpu_torch.core import categorical as tcat
from cudf_tpu_torch.utils.padding import bucket_capacity

NULLS = ["none", "some", "all"]
ROWS = [0, 1, 128, 129]  # 128 fills its capacity bucket exactly, 129 opens the next


def _null_rows(n: int, nulls: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if nulls == "none":
        return np.zeros(n, bool)
    if nulls == "all":
        return np.ones(n, bool)
    hit = rng.random(n) < 0.3
    hit[: min(n, 1)] = True  # at least one null wherever there is a row
    return hit


def _categorical(n: int, ncats: int, nulls: str, ordered: bool) -> pd.Categorical:
    rng = np.random.default_rng(n * 7 + ncats)
    codes = rng.integers(0, ncats, n)
    codes[_null_rows(n, nulls, ncats)] = -1
    return pd.Categorical.from_codes(codes, [f"c{i:03d}" for i in range(ncats)],
                                     ordered=ordered)


def _times(n: int, kind: str, nulls: str) -> np.ndarray:
    rng = np.random.default_rng(n + len(kind))
    vals = rng.integers(-(1 << 60), 1 << 60, n).view(f"{kind}[ns]")
    vals[_null_rows(n, nulls, 3)] = np.array("NaT", f"{kind}[ns]")
    return vals


def _before_categorical(cat: pd.Categorical):
    """The host conversion as it was: codes widened to int32 on the host,
    nulls found and zeroed there, then padded."""
    codes = np.asarray(cat.codes, np.int32)
    n = len(codes)
    cap = bucket_capacity(max(n, 1))
    isnull = codes < 0
    data = np.zeros(cap, np.int32)
    data[:n] = np.where(isnull, 0, codes).astype(np.int32)
    valid = None
    if isnull.any():
        valid = np.zeros(cap, bool)
        valid[:n] = ~isnull
    return data, valid


def _before_times(s: pd.Series):
    """The host conversion as it was: the int64 values padded, the nulls
    from pandas' ``isna`` on the host."""
    vals = s.to_numpy()
    n = len(vals)
    cap = bucket_capacity(n)
    data = np.zeros(cap, np.int64)
    data[:n] = vals.view(np.int64)
    isnull = s.isna().to_numpy()
    valid = None
    if isnull.any():
        valid = np.zeros(cap, bool)
        valid[:n] = ~isnull
    return data, valid


def _assert_column(col, data, valid, n):
    assert col.length == n
    assert col.data.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(col.data.numpy(), data)  # the padding included
    if valid is None:
        assert col.validity is None
    else:
        assert col.validity is not None and col.validity.dtype == torch.bool
        np.testing.assert_array_equal(col.validity.numpy(), valid)


def _assert_like_reference(tbl, pdf):
    got = tbl.to_pandas()
    pd.testing.assert_frame_equal(got, ct.Table.from_pandas(pdf).to_pandas())
    pd.testing.assert_frame_equal(got, pdf)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("nulls", NULLS)
@pytest.mark.parametrize("ncats", [3, 200], ids=["int8", "int16"])
def test_categorical_ingest_equals_the_host_conversion(ncats, nulls, n, ordered):
    cat = _categorical(n, ncats, nulls, ordered)
    assert cat.codes.dtype == (np.int8 if ncats < 128 else np.int16)
    pdf = pd.DataFrame({"k": cat})
    tbl = Table.from_pandas(pdf, device="cpu")
    col = tbl["k"]
    assert col.dtype == tcat.categorical_dtype(ordered) and tcat.ordered(col) == ordered
    assert list(col.dictionary) == list(cat.categories)
    assert col.dictionary.dtype == object
    _assert_column(col, *_before_categorical(cat), n)
    _assert_like_reference(tbl, pdf)


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("nulls", NULLS)
@pytest.mark.parametrize("kind", ["datetime64", "timedelta64"])
def test_datetime_ingest_equals_the_host_conversion(kind, nulls, n):
    pdf = pd.DataFrame({"t": _times(n, kind, nulls)})
    assert str(pdf["t"].dtype) == f"{kind}[ns]"
    tbl = Table.from_pandas(pdf, device="cpu")
    _assert_column(tbl["t"], *_before_times(pdf["t"]), n)
    _assert_like_reference(tbl, pdf)


@pytest.mark.parametrize("nulls", NULLS)
def test_from_values_and_from_codes_keep_their_codes(nulls):
    """``from_values``' int32 codes and a caller's int64 codes take the same
    device path as pandas' int8."""
    vals = np.array(["b", "a", "c", "a", "b"], object)
    if nulls != "none":
        vals[[0, 3] if nulls == "some" else slice(None)] = None
    col = tcat.from_values(vals, device="cpu")
    cat = pd.Categorical(vals)
    _assert_column(col, *_before_categorical(cat), len(vals))
    wide = tcat.from_codes(np.asarray(cat.codes, np.int64), np.asarray(cat.categories),
                           device="cpu")
    _assert_column(wide, *_before_categorical(cat), len(vals))


def _marked_frame(n: int) -> pd.DataFrame:
    return pd.DataFrame({
        "flag": _categorical(n, 3, "some", False),
        "wide": _categorical(n, 200, "some", True),
        "date": _times(n, "datetime64", "some"),
        "span": _times(n, "timedelta64", "some"),
        "clean": _times(n, "datetime64", "none"),
    })


@pytest.mark.cuda
def test_card_ingest_equals_the_cpu_ingest():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pdf = _marked_frame(300_001)
    cpu, gpu = Table.from_pandas(pdf, device="cpu"), Table.from_pandas(pdf, device="cuda")
    for name in pdf.columns:
        a, b = cpu[name], gpu[name]
        assert b.device.type == "cuda"
        assert (a.dtype, a.length, a.capacity) == (b.dtype, b.length, b.capacity)
        assert torch.equal(a.data, b.data.cpu())
        assert (a.validity is None) == (b.validity is None)
        if a.validity is not None:
            assert torch.equal(a.validity, b.validity.cpu())
        assert (a.dictionary is None) == (b.dictionary is None)
        if a.dictionary is not None:
            np.testing.assert_array_equal(a.dictionary, b.dictionary)
    pd.testing.assert_frame_equal(gpu.to_pandas(), pdf)
