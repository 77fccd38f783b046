"""I/O: parquet, CSV, JSON, ORC and feather readers and writers
(counterpart of ``cudf_tpu/io/__init__.py``).

Analog of cpp/src/io/. Decode runs on the host through pyarrow's readers,
and each column reaches the device with one host-to-device copy. A
single-file ``read_parquet`` defers every column: the table it returns
reads, decodes and copies a column only when the column is first used
(``core/table.py``, ``Deferred``), so ``read_parquet(p)["v"]`` touches only
``v`` on disk, and a column that is never used is never read. Readers take
``device=None``, which means CUDA and raises without it, as
``Table.from_pandas`` does. pyarrow is imported inside the functions, so
``import cudf_tpu_torch`` works without it.

``read_parquet`` with ``predicates=`` or a remote path (http(s), or
``s3://`` with SigV4-signed range reads, ``s3.py``) reads through
``parquet_ext.py``'s own row-group pruning and range reads
(``datasource.py``), and ``read_parquet_chunked`` is ``parquet_ext``'s
chunked reader. The other readers take a remote path too, read whole
through its datasource. The avro format is ``avro.py``.
"""
from __future__ import annotations

import glob as _glob
from typing import List, Optional, Sequence

import numpy as np

from ..core.column import Column, resolve_device
from ..core.table import Deferred, Table


_REMOTE = ("http://", "https://", "s3://")


def _source(path):
    """A local path as it is; a remote one as its bytes in a file-like."""
    if str(path).startswith(_REMOTE):
        import io as _io

        from .datasource import Datasource

        return _io.BytesIO(Datasource.open(str(path)).read_all())
    return path


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        hits = sorted(_glob.glob(str(p)))
        out.extend(hits if hits else [str(p)])
    return out


def read_parquet(paths, columns: Optional[Sequence[str]] = None, filters=None,
                 predicates=None, device=None) -> Table:
    """cudf::io::read_parquet analog (cpp/src/io/functions.cpp:631). One
    file without ``filters`` gives a table of deferred columns; several
    files, or pyarrow ``filters``, are read and copied at once.
    ``predicates`` ((column, op, literal) conjunctions) and remote paths
    (http(s), s3) go through ``parquet_ext.read_parquet_pruned``'s own stats pruning and
    range reads."""
    dev = resolve_device(device)
    expanded = _expand_paths(paths)
    if predicates is not None or any(str(p).startswith(_REMOTE) for p in expanded):
        from ..ops.copying import concatenate_tables
        from .parquet_ext import read_parquet_pruned

        tbls = [read_parquet_pruned(p, columns, predicates, device=dev) for p in expanded]
        return concatenate_tables(tbls) if len(tbls) > 1 else tbls[0]
    if len(expanded) == 1 and filters is None:
        t = _read_parquet_deferred(expanded[0], columns, dev)
        if t is not None:
            return t
    import pyarrow as pa
    import pyarrow.parquet as pq

    tbls = [pq.read_table(p, columns=list(columns) if columns else None, filters=filters)
            for p in expanded]
    return Table.from_arrow(pa.concat_tables(tbls) if len(tbls) > 1 else tbls[0], dev)


def _read_column(path: str, name: str):
    """One column of a parquet file, decoded on the host: the loader of a
    deferred column."""
    import pyarrow.parquet as pq

    with pq.ParquetFile(path) as pf:
        return pf.read(columns=[name]).column(0)


def _read_parquet_deferred(path: str, columns, dev) -> Optional[Table]:
    """A table whose columns are read from ``path`` on first use, each by
    itself (the reference's column projection, cpp/src/io/parquet column
    selection, moved to access time). Only the footer is read here. None
    when a requested column is not in the file (the eager path raises)."""
    import pyarrow.parquet as pq

    with pq.ParquetFile(path) as pf:
        schema, num_rows = pf.schema_arrow, pf.metadata.num_rows
    names = [str(c) for c in columns] if columns else list(schema.names)
    if any(n not in schema.names for n in names):
        return None
    return Table({n: Deferred(num_rows, lambda n=n: _read_column(path, n), dev,
                              _np_dtype(schema.field(n).type))
                  for n in names})


def _np_dtype(t) -> np.dtype:
    """The numpy dtype ``Column.from_arrow`` gives an arrow type: object for
    strings (dictionary-encoded or not), else pyarrow's pandas dtype."""
    import pyarrow as pa

    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return np.dtype(object)
    return np.dtype(t.to_pandas_dtype())


def read_parquet_chunked(path, columns: Optional[Sequence[str]] = None,
                         predicates=None, chunk_read_limit: int = 256 << 20,
                         pass_read_limit: int = 1 << 30, prefetch: bool = True,
                         device=None):
    """Budget-bounded chunked read (cudf's chunked_parquet_reader analog,
    reader_impl_chunking.hpp pass/subpass planning): an iterator of Tables,
    each chunk's decoded size within ``chunk_read_limit`` and the source
    bytes held at once within ``pass_read_limit``; chunk k + 1 decodes on
    the host while the caller works on chunk k."""
    from .parquet_ext import ChunkedParquetReader

    return ChunkedParquetReader(path, columns, predicates, chunk_read_limit,
                                pass_read_limit, prefetch, device=device)


def read_csv(path, columns=None, device=None, **kwargs) -> Table:
    import pyarrow.csv as pcsv

    t = Table.from_arrow(pcsv.read_csv(_source(path)), device)
    return t.select(list(columns)) if columns else t


def read_json(path, lines: bool = True, device=None, **kwargs) -> Table:
    from ..utils.real_pandas import pd

    return Table.from_pandas(pd.read_json(_source(path), lines=lines, **kwargs), device)


def read_orc(path, columns=None, device=None) -> Table:
    import pyarrow.orc as po

    return Table.from_arrow(po.read_table(_source(path),
                                          columns=list(columns) if columns else None),
                            device)


def read_feather(path, columns=None, device=None) -> Table:
    import pyarrow.feather as pf

    return Table.from_arrow(pf.read_table(_source(path),
                                         columns=list(columns) if columns else None),
                            device)


def write_parquet(tbl: Table, path: str, **kwargs) -> None:
    import pyarrow.parquet as pq

    pq.write_table(tbl.to_arrow(), path, **kwargs)


def write_csv(tbl: Table, path: str, **kwargs) -> None:
    import pyarrow.csv as pcsv

    pcsv.write_csv(tbl.to_arrow(), path)


def write_json(tbl: Table, path: str, lines: bool = True) -> None:
    tbl.to_pandas().to_json(path, orient="records", lines=lines)


def write_orc(tbl: Table, path: str) -> None:
    import pyarrow.orc as po

    po.write_table(tbl.to_arrow(), path)


def scan(fmt: str, paths: List[str], columns: Optional[List[str]] = None,
         device=None) -> Table:
    """The IR's ``Scan`` node: read ``paths`` in format ``fmt``."""
    if fmt == "parquet":
        return read_parquet(paths, columns, device=device)
    if fmt == "csv":
        return read_csv(paths[0], columns, device=device)
    if fmt == "json":
        return read_json(paths[0], device=device)
    if fmt == "orc":
        return read_orc(paths[0], columns, device=device)
    if fmt == "avro":
        from .avro import read_avro

        return read_avro(paths[0], columns, device=device)
    raise ValueError(f"unknown scan format {fmt}")


def write(tbl: Table, fmt: str, path: str) -> None:
    """The IR's ``Sink`` node: write ``tbl`` to ``path`` in format ``fmt``."""
    from .avro import write_avro

    writers = {"parquet": write_parquet, "csv": write_csv, "json": write_json,
               "orc": write_orc, "avro": write_avro}
    if fmt not in writers:
        raise ValueError(f"unknown sink format {fmt}")
    writers[fmt](tbl, path)


def parquet_metadata(path):
    """cudf::io::read_parquet_metadata analog."""
    import pyarrow.parquet as pq

    return pq.ParquetFile(path).metadata


def _read_through(f, delim: bytes, chunk: int = 1 << 20) -> bytes:
    """The bytes from ``f``'s position through the first ``delim``, or to
    EOF: a row is never cut, however long it is."""
    out = b""
    while True:
        part = f.read(chunk)
        # a delimiter may straddle two reads: search from len(delim)-1 back
        start = max(0, len(out) - len(delim) + 1)
        out += part
        cut = out.find(delim, start)
        if cut >= 0:
            return out[: cut + len(delim)]
        if not part:
            return out


def read_text(path, delimiter: str = "\n", byte_range=None, device=None) -> Column:
    """cudf::io::text multibyte_split analog: split a file, or the byte
    range (offset, size) of it, into a string column on a delimiter. A
    range starts after the first delimiter at or past its offset (unless
    the offset is 0) and runs through the first delimiter at or past its
    end, so consecutive ranges split the rows between them."""
    dev = resolve_device(device)
    src = _source(path)
    with (src if hasattr(src, "read") else open(src, "rb")) as f:
        if byte_range is not None:
            offset, size = byte_range
            f.seek(offset)
            data = f.read(size)
            data += _read_through(f, delimiter.encode())
            if offset:
                head = data.find(delimiter.encode())
                data = data[head + len(delimiter):] if head >= 0 else b""
        else:
            data = f.read()
    parts = data.decode(errors="replace").split(delimiter)
    if parts and parts[-1] == "":
        parts = parts[:-1]
    return Column.from_numpy(np.array(parts, dtype=object), device=dev)
