"""The port's parquet extensions and data sources (``io/parquet_ext.py``,
``io/datasource.py``) against cudf_tpu's: row-group pruning, pruned reads
(``read_parquet(predicates=...)``), the chunked reader's plan, budgets and
decode prefetch, the chunked writer's atomicity, and http range reads from
a local ``http.server`` (no network). The same seeded frames go through
both packages (the port on the CPU); the frames must be equal exactly."""
import http.server
import os
import socketserver
import threading
import urllib.request

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import cudf_tpu as ct
from cudf_tpu import io as RIO
from cudf_tpu.io import parquet_ext as RPX
from cudf_tpu.io.datasource import HTTPDatasource as RHTTP

import cudf_tpu_torch as tt
from cudf_tpu_torch import io as TIO
from cudf_tpu_torch.io import parquet_ext as TPX
from cudf_tpu_torch.io.datasource import BytesDatasource, Datasource, HTTPDatasource


@pytest.fixture()
def pq_file(tmp_path):
    """Four row groups with disjoint key ranges, written by the port's
    chunked writer."""
    path = str(tmp_path / "t.parquet")
    frames = [pd.DataFrame({"k": np.arange(g * 100, (g + 1) * 100),
                            "v": np.arange(100) * 1.0 + g,
                            "s": np.array([f"s{(g * 7 + i) % 5}" for i in range(100)],
                                          object)})
              for g in range(4)]
    with TPX.ParquetChunkedWriter(path, row_group_rows=100) as w:
        for f in frames:
            w.write(tt.Table.from_pandas(f, device="cpu"))
    return path, pd.concat(frames, ignore_index=True)


PREDICATES = [[("k", ">=", 250)], [("k", "==", 150)], [("k", ">", 1000)],
              [("k", "<", 100)], [("k", "in", [5, 305])], [("k", "!=", 3)],
              [("k", ">=", 120), ("k", "<=", 180)], [("s", "==", "s3")],
              [("v", "<", 0.5)]]


@pytest.mark.parametrize("preds", PREDICATES, ids=lambda p: repr(p))
def test_prune_and_pruned_read_equal_the_reference(pq_file, preds):
    path, df = pq_file
    assert TPX.prune_row_groups(path, preds) == RPX.prune_row_groups(path, preds)
    got = TPX.read_parquet_pruned(path, predicates=preds, device="cpu").to_pandas()
    ref = RPX.read_parquet_pruned(path, predicates=preds).to_pandas()
    pd.testing.assert_frame_equal(got, ref, check_dtype=False)
    through_read = TIO.read_parquet(path, predicates=preds, device="cpu").to_pandas()
    pd.testing.assert_frame_equal(through_read, RIO.read_parquet(path, predicates=preds)
                                  .to_pandas(), check_dtype=False)
    pd.testing.assert_frame_equal(through_read, got)


def test_prune_row_groups_by_stats(pq_file):
    path, _ = pq_file
    assert TPX.prune_row_groups(path, [("k", ">=", 250)]) == ([2, 3], 4)
    assert TPX.prune_row_groups(path, [("k", "==", 150)])[0] == [1]
    assert TPX.prune_row_groups(path, [("k", ">", 1000)])[0] == []


def test_pruned_read_exact_and_empty(pq_file):
    path, df = pq_file
    got = TPX.read_parquet_pruned(path, ["k", "v"], [("k", ">=", 250), ("k", "<", 320)],
                                  device="cpu")
    want = df[(df.k >= 250) & (df.k < 320)][["k", "v"]].reset_index(drop=True)
    pd.testing.assert_frame_equal(got.to_pandas(), want)
    empty = TPX.read_parquet_pruned(path, predicates=[("k", ">", 10_000)], device="cpu")
    assert empty.num_rows == 0 and empty.names == ["k", "v", "s"]


def test_chunked_writer_roundtrip_and_reference(pq_file, tmp_path):
    path, df = pq_file
    assert pq.ParquetFile(path).metadata.num_row_groups == 4
    pd.testing.assert_frame_equal(pq.read_table(path).to_pandas(), df)
    rpath = str(tmp_path / "r.parquet")
    with RPX.ParquetChunkedWriter(rpath, row_group_rows=100) as w:
        for g in range(4):
            w.write(ct.Table.from_pandas(df.iloc[g * 100:(g + 1) * 100]
                                         .reset_index(drop=True)))
    pd.testing.assert_frame_equal(pq.read_table(rpath).to_pandas(), df)


def test_chunked_writer_atomic_on_error(tmp_path):
    path = str(tmp_path / "bad.parquet")
    with pytest.raises(RuntimeError, match="boom"):
        with TPX.ParquetChunkedWriter(path) as w:
            w.write(tt.Table.from_pandas(pd.DataFrame({"x": [1, 2]}), device="cpu"))
            assert os.path.exists(path)
            raise RuntimeError("boom")
    assert not os.path.exists(path)


def test_bytes_datasource_roundtrip(pq_file):
    path, df = pq_file
    with open(path, "rb") as f:
        blob = f.read()
    got = TPX.read_parquet_pruned(BytesDatasource(blob), predicates=[("k", "<", 100)],
                                  device="cpu")
    pd.testing.assert_frame_equal(got.to_pandas(), df[df.k < 100].reset_index(drop=True))
    assert Datasource.open(blob).size() == len(blob)


def test_s3_source_names_its_roadmap_item():
    """s3:// sources, which raised until the avro and S3 slice, open as a
    SigV4-signed range source (io/s3.py); opening reads nothing."""
    from cudf_tpu_torch.io.s3 import S3Datasource

    ds = Datasource.open("s3://bucket/key.parquet")
    assert isinstance(ds, S3Datasource) and (ds.bucket, ds.key) == ("bucket", "key.parquet")


@pytest.fixture()
def http_file(pq_file):
    """``pq_file`` served from a local http.server that honours Range."""
    path, df = pq_file
    with open(path, "rb") as f:
        blob = f.read()
    ranges = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()

        def do_GET(self):
            rng = self.headers.get("Range")
            if rng:
                ranges.append(rng)
                lo, hi = (int(x) for x in rng.split("=")[1].split("-"))
                body = blob[lo:hi + 1]
                self.send_response(206)
            else:
                body = blob
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    with socketserver.TCPServer(("127.0.0.1", 0), Handler) as srv:
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            yield f"http://127.0.0.1:{srv.server_address[1]}/t.parquet", df, ranges
        finally:
            srv.shutdown()
            th.join(timeout=10)


def test_http_range_reads(http_file):
    url, df, ranges = http_file
    want = df[df.k >= 300].reset_index(drop=True)
    got = TPX.read_parquet_pruned(HTTPDatasource(url), predicates=[("k", ">=", 300)],
                                  device="cpu")
    pd.testing.assert_frame_equal(got.to_pandas(), want)
    assert ranges, "no Range requests made"
    ref = RPX.read_parquet_pruned(RHTTP(url), predicates=[("k", ">=", 300)])
    pd.testing.assert_frame_equal(got.to_pandas(), ref.to_pandas(), check_dtype=False)
    # an http path through read_parquet, and the chunked reader over http
    whole = TIO.read_parquet(url, device="cpu").to_pandas()
    pd.testing.assert_frame_equal(whole, df)
    pd.testing.assert_frame_equal(whole, RIO.read_parquet(url).to_pandas(), check_dtype=False)
    chunks = [t.to_pandas() for t in TIO.read_parquet_chunked(
        url, predicates=[("k", "<", 250)], chunk_read_limit=1, device="cpu")]
    assert len(chunks) == 3
    pd.testing.assert_frame_equal(pd.concat(chunks, ignore_index=True),
                                  df[df.k < 250].reset_index(drop=True))


def test_http_datasource_retry_and_prefetch(monkeypatch):
    """A transient failure is retried; prefetched ranges are served from
    the cache with no new request (the reference's behaviour)."""
    blob = bytes(range(256)) * 40
    calls = {"n": 0, "failed": False}

    def fake_urlopen(req, timeout=None):
        calls["n"] += 1
        if not calls["failed"]:
            calls["failed"] = True
            raise OSError("transient")
        lo, hi = map(int, req.headers["Range"][len("bytes="):].split("-"))

        class R:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def read(self):
                return blob[lo:hi + 1]
        return R()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    ds = HTTPDatasource("http://x/test", retries=3, backoff=0.0)
    assert ds._fetch(10, 50) == blob[10:60]
    assert calls["n"] == 2  # one failure and one retry
    ds.prefetch_ranges([(0, 100), (1000, 200)])
    n = calls["n"]
    assert ds._cached(20, 50) == blob[20:70]
    assert ds._cached(1050, 100) == blob[1050:1150]
    assert calls["n"] == n and ds._cached(500, 10) is None


@pytest.fixture()
def big_file(tmp_path):
    rng = np.random.default_rng(0)
    n = 200_000
    df = pd.DataFrame({"k": np.arange(n, dtype=np.int64), "v": rng.normal(size=n),
                       "s": np.array([f"id{i % 97:03d}" for i in range(n)])})
    path = str(tmp_path / "big.parquet")
    pq.write_table(pa.Table.from_pandas(df), path, row_group_size=10_000,
                   compression="snappy")
    return path, df


def test_chunked_reader_plan_budget_and_parity(big_file):
    """Every chunk fits the decoded-byte budget (a single larger row group
    reads alone), the plan is the reference's, the chunks concatenate to
    the whole file, pruning composes, and a column selection shrinks the
    plan."""
    path, df = big_file
    budget = 1 << 20
    rd = TPX.ChunkedParquetReader(path, chunk_read_limit=budget, pass_read_limit=4 << 20,
                                  device="cpu")
    ref = RPX.ChunkedParquetReader(path, chunk_read_limit=budget, pass_read_limit=4 << 20)
    assert rd.plan == ref.plan and rd.passes == ref.passes and len(rd.plan) > 3
    md = pq.ParquetFile(path).metadata
    one_rg = sum(md.row_group(0).column(j).total_uncompressed_size
                 for j in range(md.num_columns))
    assert all(b <= max(budget, one_rg) for b in rd.plan_bytes)
    assert [i for c in rd.plan for i in c] == list(range(md.num_row_groups))
    chunks = [t.to_pandas() for t in TIO.read_parquet_chunked(
        path, chunk_read_limit=budget, pass_read_limit=4 << 20, device="cpu")]
    assert len(chunks) == len(rd.plan)
    pd.testing.assert_frame_equal(pd.concat(chunks, ignore_index=True), df)

    rd2 = TPX.ChunkedParquetReader(path, predicates=[("k", ">=", 150_000)],
                                   chunk_read_limit=budget, device="cpu")
    assert {i for c in rd2.plan for i in c} == set(range(15, 20))
    got2 = pd.concat([t.to_pandas() for t in rd2], ignore_index=True)
    pd.testing.assert_frame_equal(got2, df[df.k >= 150_000].reset_index(drop=True))

    rd3 = TPX.ChunkedParquetReader(path, columns=["k"], chunk_read_limit=budget,
                                   device="cpu")
    assert len(rd3.plan) < len(rd.plan)
    pd.testing.assert_frame_equal(pd.concat([t.to_pandas() for t in rd3],
                                            ignore_index=True), df[["k"]])
    none = TPX.ChunkedParquetReader(path, columns=["k"], predicates=[("k", "<", 0)],
                                    device="cpu")
    (empty,) = list(none)
    assert empty.num_rows == 0 and empty.names == ["k"]


def test_chunked_reader_decodes_on_a_worker_and_copies_on_the_consumer(big_file):
    path, df = big_file
    rd = TPX.ChunkedParquetReader(path, chunk_read_limit=400_000, device="cpu")
    decode_threads, copy_threads = set(), set()
    decode, to_table = rd._decode, rd._to_table

    def spy_decode(rgs):
        decode_threads.add(threading.get_ident())
        return decode(rgs)

    def spy_to_table(at):
        copy_threads.add(threading.get_ident())
        return to_table(at)

    rd._decode, rd._to_table = spy_decode, spy_to_table
    total = sum(t.num_rows for t in rd)
    assert total == len(df)
    assert threading.get_ident() not in decode_threads
    assert copy_threads == {threading.get_ident()}


def test_chunked_reader_worker_exception_reaches_the_caller(big_file):
    path, _ = big_file
    rd = TPX.ChunkedParquetReader(path, chunk_read_limit=400_000, device="cpu")
    decode, seen = rd._decode, []

    def failing(rgs):
        if seen:
            raise OSError("disk gone")
        seen.append(rgs)
        return decode(rgs)

    rd._decode = failing
    it = iter(rd)
    assert next(it).num_rows > 0
    with pytest.raises(OSError, match="disk gone"):
        next(it)
