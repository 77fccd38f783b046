"""The port's row hashers (``ops/crypto_hash.py``) against hashlib, pure
Python XXH32/XXH64 and cudf_tpu's.

Tolerance: exact (digest strings and hash words). md5/sha* are held to
hashlib over the documented row bytes (the little-endian bytes of each
non-null value, a float with NaN made quiet and -0.0 made +0.0, a string's
UTF-8), including messages of several blocks, nulls and strings. xxhash is
held to the pure Python oracles (copied from ``tests/test_crypto_hash.py``)
over the u32 equality words and to the reference. The reference is called
once per algorithm at a small shape: its unrolled rounds compile slowly on
the CPU.
"""
import hashlib
import struct

import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import crypto_hash as RC

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import crypto_hash as TC
from cudf_tpu_torch.ops.hashing import equality_words

ALGOS = ["md5", "sha1", "sha224", "sha256", "sha384", "sha512"]


def _norm(v):
    """A value's bytes in the row message."""
    if isinstance(v, str):
        return v.encode("utf-8")
    v = np.asarray(v)
    if v.dtype.kind == "f":
        if np.isnan(v):
            v = np.asarray(np.nan, v.dtype)
        elif v == 0:
            v = np.zeros((), v.dtype)
    return v.tobytes()


def _oracle(algo, rows):
    return [getattr(hashlib, algo)(b"".join(_norm(v) for v in r if v is not None)).hexdigest()
            for r in rows]


def _frame(n=150, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "a": rng.integers(-(2**40), 2**40, n).astype(np.int64),
        "b": rng.standard_normal(n),
        "c": rng.integers(0, 100, n).astype(np.int32),
        "f": rng.standard_normal(n).astype(np.float32),
        "s": rng.choice(["", "wo", "héllo", "x" * 70, "y" * 150], n),
        "m": pd.array(rng.integers(-5, 5, n), dtype="Int16"),
        "t": rng.random(n) > 0.5,
    })
    df.loc[rng.random(n) < 0.2, "m"] = pd.NA
    df.loc[rng.random(n) < 0.1, "s"] = None
    df.loc[::11, "b"] = np.nan
    df.loc[::13, "f"] = -0.0
    return df


_TYPES = {"a": np.int64, "b": np.float64, "c": np.int32, "f": np.float32, "m": np.int16,
          "t": np.bool_}


def _rows(df):
    """Each row's values as the message sees them: None for a null, a str,
    or a numpy scalar of the column's type (NaN stays a value in "b")."""
    out = []
    for rec in df.to_dict("records"):
        row = []
        for name, v in rec.items():
            if name == "s":
                row.append(v if isinstance(v, str) else None)
            elif name == "m" and pd.isna(v):
                row.append(None)
            else:
                row.append(_TYPES[name](v))
        out.append(row)
    return out


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return df, tt.Table.from_pandas(df, device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
def test_digests_equal_hashlib(data, algo):
    df, t = data
    got = TC.hexdigest(t.columns, algo)
    assert got.dtype.is_string and got.length == len(df)
    assert list(got.to_numpy()) == _oracle(algo, _rows(df))
    assert list(got.dictionary) == sorted(set(got.dictionary))


@pytest.mark.parametrize("algo", ALGOS)
def test_digests_equal_the_reference(algo):
    df = _frame(24, seed=1).drop(columns=["f"])  # the reference's f32 bytes keep -0.0
    df["b"] = df["b"].fillna(1.0)
    r = ct.Table.from_pandas(df)
    t = tt.Table.from_pandas(df, device="cpu")
    got = getattr(TC, algo)(t.columns)
    want = getattr(RC, algo)(r.columns)
    assert list(got.to_numpy()) == list(want.to_numpy())
    np.testing.assert_array_equal(got.data[:24].numpy(), np.asarray(want.data)[:24])


def test_digest_multiblock_and_empty():
    s = np.array(["x" * 150, "y" * 7, "", "z" * 55, "w" * 56, "v" * 119, "u" * 111], object)
    t = tt.Table.from_pandas(pd.DataFrame({"s": s}), device="cpu")
    for algo in ALGOS:
        got = TC.hexdigest(t.columns, algo).to_numpy()
        assert list(got) == [getattr(hashlib, algo)(v.encode()).hexdigest() for v in s]
    none = tt.Table.from_pandas(pd.DataFrame({"s": np.array([None, None], object)}),
                                device="cpu")
    assert list(TC.md5(none.columns).to_numpy()) == [hashlib.md5(b"").hexdigest()] * 2
    empty = tt.Table.from_pandas(pd.DataFrame({"a": np.array([], np.int64)}), device="cpu")
    assert TC.sha256(empty.columns).length == 0


def test_reference_float_bytes_differ_from_its_own_contract():
    """The reference's f32 bytes keep -0.0, so an f32 -0.0 digests apart
    from +0.0 (its f64 -0.0 does not), and its f64 bytes flush a subnormal
    to zero; the port normalizes -0.0 in both widths and keeps subnormals."""
    f32 = pd.DataFrame({"f": np.array([-0.0, 0.0], np.float32)})
    got = TC.md5(tt.Table.from_pandas(f32, device="cpu").columns).to_numpy()
    assert got[0] == got[1] == hashlib.md5(struct.pack("<f", 0.0)).hexdigest()
    ref = RC.md5(ct.Table.from_pandas(f32).columns).to_numpy()
    assert ref[0] != ref[1]
    sub = pd.DataFrame({"d": np.array([5e-324, 0.0])})
    got = TC.md5(tt.Table.from_pandas(sub, device="cpu").columns).to_numpy()
    assert got[0] == hashlib.md5(struct.pack("<d", 5e-324)).hexdigest() != got[1]
    ref = RC.md5(ct.Table.from_pandas(sub).columns).to_numpy()
    assert ref[0] == ref[1]


# ---------------------------------------------------------------- XXH oracle
def _xxh32_ref(data: bytes, seed=0):
    P1, P2, P3, P4, P5 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed, (seed - P1) & M]
        while n - i >= 16:
            for l in range(4):
                w = int.from_bytes(data[i + 4 * l : i + 4 * l + 4], "little")
                v[l] = (rotl((v[l] + w * P2) & M, 13) * P1) & M
            i += 16
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while n - i >= 4:
        w = int.from_bytes(data[i : i + 4], "little")
        h = (rotl((h + w * P3) & M, 17) * P4) & M
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def _xxh64_ref(data: bytes, seed=0):
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
    M = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def rnd(acc, x):
        return (rotl((acc + x * P2) & M, 31) * P1) & M

    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed, (seed - P1) & M]
        while n - i >= 32:
            for l in range(4):
                w = int.from_bytes(data[i + 8 * l : i + 8 * l + 8], "little")
                v[l] = rnd(v[l], w)
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
        for l in range(4):
            h = ((h ^ rnd(0, v[l])) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while n - i >= 8:
        w = int.from_bytes(data[i : i + 8], "little")
        h = (rotl(h ^ rnd(0, w), 27) * P1 + P4) & M
        i += 8
    while n - i >= 4:
        w = int.from_bytes(data[i : i + 4], "little")
        h = (rotl(h ^ ((w * P1) & M), 23) * P2 + P3) & M
        i += 4
    while i < n:
        h = (rotl(h ^ ((data[i] * P5) & M), 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h


def _stream(cols, row):
    ws = [int(w[row]) for c in cols for w in equality_words(c)]
    return b"".join(w.to_bytes(4, "little") for w in ws)


@pytest.mark.parametrize("ncols,seed", [(1, 0), (2, 0), (3, 42), (5, 7), (9, 1)])
def test_xxhash_equals_the_python_oracles(ncols, seed):
    rng = np.random.default_rng(ncols)
    cols = []
    for k in range(ncols):
        if k % 3 == 1:
            cols.append(tt.Column.from_numpy(rng.standard_normal(17), device="cpu"))
        elif k % 3 == 2:
            cols.append(tt.Column.from_numpy(rng.integers(0, 9, 17).astype(np.int32),
                                             rng.random(17) > 0.3, device="cpu"))
        else:
            cols.append(tt.Column.from_numpy(rng.integers(0, 1000, 17).astype(np.int64),
                                             device="cpu"))
    got32 = TC.xxhash_32(cols, seed).to_numpy()
    got64 = TC.xxhash_64(cols, seed).to_numpy()
    for r in range(17):
        stream = _stream(cols, r)
        assert int(got32[r]) == _xxh32_ref(stream, seed), r
        assert int(got64[r]) == _xxh64_ref(stream, seed), r


@pytest.mark.parametrize("fn", ["xxhash_32", "xxhash_64"])
def test_xxhash_equals_the_reference(fn):
    df = _frame(40, seed=2).drop(columns=["f"])
    r, t = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    np.testing.assert_array_equal(getattr(TC, fn)(t.columns, 5).to_numpy(),
                                  getattr(RC, fn)(r.columns, 5).to_numpy())
    a = tt.Column.from_numpy(np.array([1.0, 2.0, 1.0]), np.array([False, True, False]),
                             device="cpu")
    h = getattr(TC, fn)([a]).to_numpy()
    assert h[0] == h[2] != h[1]


@pytest.mark.parametrize("method", ["murmur3", "xxhash32", "xxhash64"] + ALGOS)
def test_frame_hash_values_every_method(data, method):
    df, _ = data
    got = tt.DataFrame(df[["a", "b", "s"]], device="cpu").hash_values(method).to_pandas()
    ref = ct.DataFrame.from_pandas(df[["a", "b", "s"]].fillna({"b": 0.0})).hash_values(method)
    assert len(got) == len(df)
    if method in ALGOS:
        assert list(got) == _oracle(method, [r[:1] + r[1:2] + r[4:5] for r in _rows(df)])
    else:
        same = tt.DataFrame(df[["a", "b", "s"]].fillna({"b": 0.0}), device="cpu")
        np.testing.assert_array_equal(same.hash_values(method).to_pandas().to_numpy(),
                                      ref.to_pandas().to_numpy())
    with pytest.raises(ValueError):
        tt.DataFrame(df[["a"]], device="cpu").hash_values("crc32")
