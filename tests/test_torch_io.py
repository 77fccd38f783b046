"""The port's readers and writers (``io/``), Arrow and DLPack interop
(``core/interop.py``, ``Column``/``Table`` ``from_arrow``/``to_arrow``)
and deferred column decode, against cudf_tpu's.

Frames made from a numpy seed over the dtypes of
``tests/test_dtype_cartesian.py``, with nulls, NaN, strings, timestamps and
empty tables, are written to a temporary directory and read back by both
packages (the port on the CPU); the frames must be equal exactly.
"""
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.feather as pfeather
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu import io as RIO
from cudf_tpu.core import interop as RINT

import cudf_tpu_torch as tt
from cudf_tpu_torch import io as TIO
from cudf_tpu_torch.core import interop as TINT
from cudf_tpu_torch.core.table import Deferred

DTYPES = ["int8", "int16", "int32", "int64", "uint32", "float32", "float64", "bool",
          "str", "datetime64[ns]"]


def _frame(n, seed, nulls):
    """One column per dtype; with ``nulls`` about 10% nulls in the float,
    string and timestamp columns (as test_dtype_cartesian has them), and a
    NaN in each float column."""
    rng = np.random.default_rng(seed)
    cols = {}
    for dt in DTYPES:
        if dt == "str":
            v = pd.Series(rng.choice(["aa", "b", "cc", "dd", "e", ""], n), dtype=object)
        elif dt == "bool":
            v = pd.Series(rng.random(n) < 0.5)
        elif dt.startswith("datetime"):
            v = pd.Series(pd.Timestamp("1969-12-30")
                          + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"))
        elif dt.startswith("float"):
            v = pd.Series(rng.normal(size=n).astype(dt))
            if n:
                v.iloc[0] = np.nan
        else:
            v = pd.Series(rng.integers(0 if dt.startswith("u") else -100, 100, n).astype(dt))
        if nulls and n and dt in ("float32", "float64", "str", "datetime64[ns]"):
            v[rng.choice(n, max(n // 10, 1), replace=False)] = None
        cols[dt.split("[")[0]] = v
    return pd.DataFrame(cols)


def _write(fmt, df, path):
    """Write ``df`` through the port (its writer, or pyarrow for feather)."""
    tbl = tt.Table.from_pandas(df, device="cpu")
    if fmt == "feather":
        pfeather.write_feather(tbl.to_arrow(), path)
    else:
        getattr(TIO, f"write_{fmt}")(tbl, path)


FORMATS = ["parquet", "csv", "json", "orc", "feather"]


@pytest.mark.parametrize("case", ["plain", "nulls", "empty"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_round_trip_matches_reference(tmp_path, fmt, case):
    df = _frame(0 if case == "empty" else 300, 3, case == "nulls")
    if fmt == "orc":
        df = df.drop(columns=["uint32"])  # ORC has no unsigned types
    if fmt == "json" and case == "empty":
        df = df[["int64", "float64"]]  # an empty JSON file has no schema
    path = str(tmp_path / f"t.{fmt}")
    _write(fmt, df, path)
    read = {"parquet": "read_parquet", "csv": "read_csv", "json": "read_json",
            "orc": "read_orc", "feather": "read_feather"}[fmt]
    got = getattr(TIO, read)(path, device="cpu").to_pandas()
    want = getattr(RIO, read)(path).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    if fmt in ("parquet", "orc", "feather"):  # typed formats: the values come back
        ns = {"datetime64": "datetime64[ns]"}  # ORC stores ns, pandas makes us
        want = tt.Table.from_pandas(df, device="cpu").to_pandas()
        pd.testing.assert_frame_equal(got.astype(ns), want.astype(ns), check_dtype=False)


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json", "orc"])
def test_scan_and_write_match_reference(tmp_path, fmt):
    df = _frame(200, 4, True).drop(columns=["uint32"])
    path = str(tmp_path / f"s.{fmt}")
    TIO.write(tt.Table.from_pandas(df, device="cpu"), fmt, path)
    cols = ["int64", "str"] if fmt in ("parquet", "csv", "orc") else None
    got = TIO.scan(fmt, [path], cols, device="cpu").to_pandas()
    pd.testing.assert_frame_equal(got, RIO.scan(fmt, [path], cols).to_pandas())


def test_parquet_read_by_pandas_matches_reference(tmp_path):
    df = _frame(500, 5, True)
    path = str(tmp_path / "pd.parquet")
    df.to_parquet(path)
    got = TIO.read_parquet(path, device="cpu")
    pd.testing.assert_frame_equal(got.to_pandas(), RIO.read_parquet(path).to_pandas())
    for name, c in RIO.read_parquet(path, ["str", "int8"]):
        t = TIO.read_parquet(path, ["str", "int8"], device="cpu")[name]
        np.testing.assert_array_equal(t.to_numpy(), c.to_numpy())


def test_multi_file_and_filters_read_eagerly(tmp_path):
    df = _frame(400, 6, False)
    for i in range(2):
        df.iloc[i * 200:(i + 1) * 200].to_parquet(str(tmp_path / f"part{i}.parquet"))
    glob = str(tmp_path / "part*.parquet")
    got = TIO.read_parquet(glob, device="cpu")
    assert got.undecoded() == []
    pd.testing.assert_frame_equal(got.to_pandas(), RIO.read_parquet(glob).to_pandas())
    flt = [("int64", ">", 0)]
    one = str(tmp_path / "part0.parquet")
    pd.testing.assert_frame_equal(TIO.read_parquet(one, filters=flt, device="cpu").to_pandas(),
                                  RIO.read_parquet(one, filters=flt).to_pandas())


# ------------------------------------------------------------ deferred decode
def test_read_parquet_decodes_only_what_is_used(tmp_path, monkeypatch):
    """bench.py's scan shape, small: read_parquet(p)["v"] reads and decodes
    only v; untouched columns are never read; host exports copy nothing
    to the device; select/drop/rename keep columns deferred."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"k": rng.integers(0, 50, 5000),
                       "v": rng.normal(size=5000).astype(np.float32),
                       "w": rng.normal(size=5000).astype(np.float32)})
    path = str(tmp_path / "scan.parquet")
    df.to_parquet(path)
    reads, built = [], []
    inner = TIO._read_column
    monkeypatch.setattr(TIO, "_read_column", lambda p, n: reads.append(n) or inner(p, n))
    inner_col = Deferred.column
    monkeypatch.setattr(Deferred, "column", lambda self: built.append(1) or inner_col(self))

    t = TIO.read_parquet(path, device="cpu")
    assert reads == [] and t.num_rows == 5000 and t.undecoded() == ["k", "v", "w"]
    v = t["v"]
    assert reads == ["v"] and t.undecoded() == ["k", "w"]
    np.testing.assert_array_equal(v.to_numpy(), df["v"].to_numpy())
    assert float(v.data[: v.length].sum()) == pytest.approx(float(df["v"].sum()), rel=1e-5)
    assert t["v"] is v and reads == ["v"]
    sub = t.select(["k", "v"]).rename({"k": "key"}).drop(["v"])
    assert sub.undecoded() == ["key"] and reads == ["v"]
    n_built = len(built)
    pd.testing.assert_frame_equal(t.to_pandas(), df)  # a host export
    assert t.undecoded() == ["k", "w"] and len(built) == n_built
    assert sorted(reads) == ["k", "v", "w"]


def test_read_parquet_deferred_columns_in_a_plan(tmp_path, monkeypatch):
    """A Scan feeding a filter and a projection reads only the columns the
    plan uses: the projection pushdown reaches the deferred scan."""
    from cudf_tpu_torch.expr import expressions as TE
    from cudf_tpu_torch.expr import ir as TIR

    df = pd.DataFrame({"a": np.arange(100), "b": np.arange(100) * 2.0,
                       "c": np.arange(100) % 7})
    path = str(tmp_path / "p.parquet")
    df.to_parquet(path)
    reads = []
    inner = TIO._read_column
    monkeypatch.setattr(TIO, "_read_column", lambda p, n: reads.append(n) or inner(p, n))
    plan = TIR.Select((TE.NamedExpr("b2", TE.col("b") * 2),), children=(
        TIR.Filter(TE.col("c") > 3, children=(
            TIR.Scan("parquet", (path,), device="cpu"),)),))
    out = TIR.execute(plan).to_pandas()
    np.testing.assert_array_equal(out["b2"].to_numpy(), df.b[df.c > 3].to_numpy() * 2)
    assert sorted(reads) == ["b", "c"]
    reads.clear()  # the profile's per-node synchronize decodes nothing either
    out, profile = TIR.execute_with_profile(plan)
    np.testing.assert_array_equal(out["b2"].to_numpy(), df.b[df.c > 3].to_numpy() * 2)
    assert sorted(reads) == ["b", "c"]
    assert [name for name, _, _ in profile] == ["Scan", "Filter", "Select"]


def test_parquet_strings_join_with_ingested_strings(tmp_path):
    """A string column read from parquet holds the codes and dictionary of
    from_numpy on the same values, so it joins with a from_pandas column."""
    from cudf_tpu_torch import join

    rng = np.random.default_rng(2)
    left = pd.DataFrame({"k": rng.choice(["x", "yy", "zzz", "w"], 300),
                         "v": rng.normal(size=300)})
    right = pd.DataFrame({"k": ["yy", "w", "q", "x"], "name": [10, 20, 30, 40]})
    path = str(tmp_path / "l.parquet")
    left.to_parquet(path)
    lt = TIO.read_parquet(path, device="cpu")
    ref = tt.Column.from_numpy(left["k"].to_numpy(object), device="cpu")
    np.testing.assert_array_equal(lt["k"].dictionary, ref.dictionary)
    np.testing.assert_array_equal(lt["k"].data.numpy(), ref.data.numpy())
    out = join(lt, tt.Table.from_pandas(right, device="cpu"), ["k"], ["k"], "inner")
    want = left.merge(right, on="k")
    got = out.to_pandas().sort_values(["k", "v"]).reset_index(drop=True)
    want = want.sort_values(["k", "v"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got[list(want.columns)], want, check_dtype=False)


# ---------------------------------------------------------------- arrow
ARROW_ARRAYS = {
    "strings_nulls": pa.array(["b", None, "a", "b", "", None]),
    "large_strings": pa.array(["x", "yy", None], pa.large_string()),
    "dictionary": pa.array(["q", "p", "q", None]).dictionary_encode(),
    "ints_nulls": pa.array([1, None, 3], pa.int32()),
    "floats_nan": pa.array([1.5, float("nan"), None]),
    "bools": pa.array([True, None, False]),
    "timestamps": pa.array([0, None, 86_400_000_000_000], pa.timestamp("ns")),
    "chunked": pa.chunked_array([[1, 2], [3, None]]),
    "empty_strings": pa.array([], pa.string()),
}


@pytest.mark.parametrize("name", list(ARROW_ARRAYS))
def test_column_from_arrow_matches_reference_and_from_numpy(name):
    arr = ARROW_ARRAYS[name]
    got, want = tt.Column.from_arrow(arr, device="cpu"), ct.Column.from_arrow(arr)
    g, w = got.to_numpy(), want.to_numpy()
    np.testing.assert_array_equal(pd.isna(pd.Series(g)), pd.isna(pd.Series(w)))
    ok = ~pd.isna(pd.Series(w)).to_numpy()
    np.testing.assert_array_equal(g[ok], w[ok])
    if got.dtype.is_string:  # codes and dictionary of from_numpy on the values
        vals = (arr.to_pandas() if isinstance(arr, pa.ChunkedArray)
                else pd.Series(arr.to_pylist(), dtype=object)).to_numpy(object)
        ref = tt.Column.from_numpy(vals, validity=~pd.isna(vals), device="cpu")
        np.testing.assert_array_equal(got.dictionary, ref.dictionary)
        np.testing.assert_array_equal(got.data.numpy(), ref.data.numpy())
    back = got.to_arrow()
    assert back.to_pylist() == want.to_arrow().to_pylist() or name == "floats_nan"
    assert back.null_count == want.to_arrow().null_count


def test_table_arrow_round_trip_matches_reference():
    df = _frame(100, 8, True)
    at = pa.Table.from_pandas(df, preserve_index=False)
    got = tt.Table.from_arrow(at, device="cpu")
    pd.testing.assert_frame_equal(got.to_pandas(), ct.Table.from_arrow(at).to_pandas())
    assert got.to_arrow().equals(ct.Table.from_arrow(at).to_arrow())


def test_dlpack_and_arrow_c_interface():
    """tests/test_long_tail.py's interop cases, and table_to_dlpack."""
    c = tt.Column.from_numpy(np.arange(10, dtype=np.float32), device="cpu")
    back = TINT.from_dlpack(TINT.to_dlpack(c))
    np.testing.assert_array_equal(back.to_numpy(), np.arange(10, dtype=np.float32))
    assert back.capacity == c.capacity
    t = torch.arange(5, dtype=torch.int64)
    assert TINT.from_dlpack(t).to_numpy().tolist() == [0, 1, 2, 3, 4]
    c = tt.Column.from_numpy(np.array([1.5, np.nan, 3.0]), device="cpu")
    ca, cs, _ = TINT.to_arrow_c(c)
    back = TINT.from_arrow_c(ca, cs, device="cpu")
    np.testing.assert_allclose(back.to_numpy(), c.to_numpy(), equal_nan=True)
    df = pd.DataFrame({"a": [1, 2, 3], "b": [0.5, 1.5, 2.5]})
    got = torch.utils.dlpack.from_dlpack(
        TINT.table_to_dlpack(tt.Table.from_pandas(df, device="cpu")))
    want = np.asarray(RINT.table_to_dlpack(ct.Table.from_pandas(df)))
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- read_text
def test_read_text_matches_reference(tmp_path):
    path = str(tmp_path / "t.txt")
    lines = [f"row {i} " + "x" * (i % 13) for i in range(200)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert TIO.read_text(path, device="cpu").to_numpy().tolist() == lines
    size = os.path.getsize(path)
    parts = []
    for off in range(0, size, 500):
        got = TIO.read_text(path, byte_range=(off, 500), device="cpu").to_numpy()
        want = RIO.read_text(path, byte_range=(off, 500)).to_numpy()
        np.testing.assert_array_equal(got, want)
        parts += got.tolist()
    assert parts == lines  # consecutive ranges split the rows between them
    got = TIO.read_text(path, delimiter="x\n", device="cpu").to_numpy()
    np.testing.assert_array_equal(got, RIO.read_text(path, delimiter="x\n").to_numpy())


def test_read_text_range_keeps_a_long_row_whole(tmp_path):
    """A range reads on to its delimiter however far it is: rows of 10 B,
    3 MiB, 10 B and 10 B split at byte 20 come back whole. The reference
    looks only 1 MiB past a range's end and cuts the long row."""
    path = str(tmp_path / "long.txt")
    lines = ["a" * 9, "b" * (3 << 20), "c" * 9, "d" * 9]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    size = os.path.getsize(path)
    whole = TIO.read_text(path, device="cpu").to_numpy().tolist()
    parts = []
    for rng in ((0, 20), (20, size - 20)):
        parts += TIO.read_text(path, byte_range=rng, device="cpu").to_numpy().tolist()
    assert parts == whole == lines
    ref = RIO.read_text(path, byte_range=(0, 20)).to_numpy().tolist()
    ref += RIO.read_text(path, byte_range=(20, size - 20)).to_numpy().tolist()
    assert ref == ["a" * 9, "b" * 10, "c" * 9, "d" * 9]


def test_a_literal_decodes_no_deferred_column(tmp_path):
    """A literal's column takes the table's device without decoding a
    deferred column: after each expression only the columns it names are
    decoded."""
    from cudf_tpu_torch.expr import expressions as TE

    df = pd.DataFrame({"a": np.arange(10), "b": np.arange(10) * 0.5,
                       "c": np.arange(10) % 3})
    path = str(tmp_path / "abc.parquet")
    df.to_parquet(path)
    cases = [(TE.when(TE.col("a") > 2).then(TE.lit(1)).otherwise(TE.lit(0)),
              np.where(df.a > 2, 1, 0), ["b", "c"]),
             (TE.lit(1) + TE.lit(2), np.full(10, 3), ["a", "b", "c"]),
             (TE.lit(7).cast(tt.dtypes.float64), np.full(10, 7.0), ["a", "b", "c"])]
    for expr, want, undecoded in cases:
        t = TIO.read_parquet(path, device="cpu")
        got = TE.evaluate(expr, t)
        np.testing.assert_array_equal(got.to_numpy(), want)
        assert t.undecoded() == undecoded


# ---------------------------------------------------------- the boundaries
def test_readers_default_to_cuda(tmp_path):
    df = pd.DataFrame({"a": [1, 2]})
    p = str(tmp_path / "d.parquet")
    df.to_parquet(p)
    df.to_csv(str(tmp_path / "d.csv"), index=False)
    calls = [lambda: TIO.read_parquet(p), lambda: TIO.scan("parquet", [p]),
             lambda: TIO.read_csv(str(tmp_path / "d.csv")),
             lambda: TIO.read_text(str(tmp_path / "d.csv")),
             lambda: tt.read_parquet(p),
             lambda: tt.Table.from_arrow(pa.table({"a": [1]})),
             lambda: tt.Column.from_arrow(pa.array([1]))]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            if isinstance(out, tt.DataFrame):  # the top-level readers' frames
                out = out.table
            col = out if isinstance(out, tt.Column) else out.columns[0]
            assert col.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_unported_io_names_its_roadmap_item(tmp_path):
    p = str(tmp_path / "d.parquet")
    pd.DataFrame({"a": [1]}).to_parquet(p)
    cases = [(lambda: TIO.read_parquet(p, predicates=[("a", ">", 0)], device="cpu"),
              "item 13"),
             (lambda: TIO.read_parquet("http://localhost/x.parquet", device="cpu"), "item 13"),
             (lambda: TIO.scan("avro", [p], device="cpu"), "item 13"),
             (lambda: TIO.write(tt.Table.from_pandas(pd.DataFrame({"a": [1]}), device="cpu"),
                                "avro", p), "item 13"),
             (lambda: TIO.read_parquet_chunked(p), "item 15")]
    for call, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            call()
    assert TIO.parquet_metadata(p).num_rows == RIO.parquet_metadata(p).num_rows == 1
