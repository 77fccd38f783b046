"""Datasource abstraction: local files, HTTP(S) range reads, in-memory bytes
(counterpart of ``cudf_tpu/io/datasource.py``, carried over as it is: it
imports no framework).

The analog of cudf::io::datasource over kvikio (reference:
cpp/include/cudf/io/datasource.hpp:32, cpp/src/io/utilities/datasource.cpp:
16-31 — GDS file, mmap, remote S3/HTTP/HDFS). Readers consume a Datasource
and ask for (offset, size) ranges; remote sources satisfy them with HTTP
Range requests so row-group pruning never downloads skipped bytes;
``s3://`` sources are ``io/s3.py``'s SigV4-signed range reads over
``HTTPDatasource``.
"""
from __future__ import annotations

import io
import os
import urllib.request
from typing import Optional, Union


class Datasource:
    """Random-access byte source."""

    def size(self) -> int:
        raise NotImplementedError

    def read(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def read_all(self) -> bytes:
        return self.read(0, self.size())

    # pyarrow interop: a seekable file-like over this source
    def as_file(self):
        return _DatasourceFile(self)

    @staticmethod
    def open(src: Union[str, bytes, "Datasource"]) -> "Datasource":
        if isinstance(src, Datasource):
            return src
        if isinstance(src, (bytes, bytearray, memoryview)):
            return BytesDatasource(bytes(src))
        s = str(src)
        if s.startswith("s3://"):
            from .s3 import S3Datasource

            return S3Datasource(s)
        if s.startswith("http://") or s.startswith("https://"):
            return HTTPDatasource(s)
        return FileDatasource(s)


class FileDatasource(Datasource):
    def __init__(self, path: str):
        self.path = path
        self._size = os.path.getsize(path)

    def size(self) -> int:
        return self._size

    def read(self, offset: int, size: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(size)


class BytesDatasource(Datasource):
    def __init__(self, data: bytes):
        self._data = data

    def size(self) -> int:
        return len(self._data)

    def read(self, offset: int, size: int) -> bytes:
        return self._data[offset : offset + size]


class HTTPDatasource(Datasource):
    """HTTP(S) range-request source (datasource.cpp remote analog).

    Falls back to a full download when the server ignores Range headers.
    Transient failures retry with exponential backoff; ``prefetch_ranges``
    fetches many ranges in parallel threads into a range cache (the
    kvikio parallel-read analog), so a chunked reader can overlap the
    next pass's network fetch with the current pass's decode+device work.
    """

    def __init__(self, url: str, timeout: float = 60.0, retries: int = 3,
                 backoff: float = 0.5):
        self.url = url
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self._size: Optional[int] = None
        self._full: Optional[bytes] = None
        self._range_cache: list = []  # [(offset, bytes)] non-overlapping

    def _headers(self, extra: dict, method: str = "GET") -> dict:
        """Request-header hook: subclasses add auth (e.g. S3 SigV4)."""
        return extra

    def _retrying(self, fn):
        import time as _time

        last = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — urllib raises many types
                last = e
                if attempt < self.retries:
                    _time.sleep(self.backoff * (2 ** attempt))
        raise last

    def _cached(self, offset: int, size: int) -> Optional[bytes]:
        for off, blob in self._range_cache:
            if off <= offset and offset + size <= off + len(blob):
                return blob[offset - off : offset - off + size]
        return None

    def prefetch_ranges(self, ranges, max_workers: int = 8) -> None:
        """Fetch [(offset, size), ...] concurrently into the range cache."""
        from concurrent.futures import ThreadPoolExecutor

        todo = [(o, s) for o, s in ranges
                if s > 0 and self._cached(o, s) is None and self._full is None]
        if not todo:
            return
        with ThreadPoolExecutor(max_workers=min(max_workers, len(todo))) as ex:
            blobs = list(ex.map(lambda r: self._fetch(r[0], r[1]), todo))
        for (o, _), b in zip(todo, blobs):
            if self._full is None:
                self._range_cache.append((o, b))

    def _fetch(self, offset: int, size: int) -> bytes:
        def go():
            req = urllib.request.Request(
                self.url,
                headers=self._headers(
                    {"Range": f"bytes={offset}-{offset + size - 1}"}))
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        data = self._retrying(go)
        if len(data) > size:  # server ignored Range: cache the full body
            self._full = data
            self._size = len(data)
            return data[offset : offset + size]
        return data

    def size(self) -> int:
        if self._size is None:
            req = urllib.request.Request(self.url, method="HEAD",
                                         headers=self._headers({}, "HEAD"))
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                cl = r.headers.get("Content-Length")
                if cl is None:
                    self._full = self.read_all()
                    self._size = len(self._full)
                else:
                    self._size = int(cl)
        return self._size

    def read(self, offset: int, size: int) -> bytes:
        if self._full is not None:
            return self._full[offset : offset + size]
        hit = self._cached(offset, size)
        if hit is not None:
            return hit
        return self._fetch(offset, size)

    def read_all(self) -> bytes:
        if self._full is None:
            def go():
                req = urllib.request.Request(self.url,
                                             headers=self._headers({}))
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return r.read()
            self._full = self._retrying(go)
            self._size = len(self._full)
        return self._full


class _DatasourceFile(io.RawIOBase):
    """Seekable file-like view for pyarrow readers."""

    def __init__(self, ds: Datasource):
        self._ds = ds
        self._pos = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, offset, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = self._ds.size() + offset
        return self._pos

    def tell(self):
        return self._pos

    def read(self, size=-1):
        if size is None or size < 0:
            size = self._ds.size() - self._pos
        data = self._ds.read(self._pos, size)
        self._pos += len(data)
        return data

    def readall(self):
        return self.read(-1)
