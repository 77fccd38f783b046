"""Interop: DLPack and the Arrow C Data Interface (counterpart of
``cudf_tpu/core/interop.py``).

Analog of cpp/src/interop/ (dlpack.cpp, to_arrow_device.cu,
from_arrow_host.cu). A column's tensor is exchanged through
``torch.utils.dlpack``, without a copy on the same device; Arrow interop
goes through pyarrow on the host, whose ``_export_to_c``/``_import_from_c``
fill the C Data Interface structs.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import dlpack as _dlpack

from . import dtypes
from .column import Column
from .table import Table
from ..utils.padding import bucket_capacity


def to_dlpack(col: Column):
    """The column's logical rows as a DLPack capsule. DLPack has no null
    mask (as with cudf::to_dlpack): export ``validity`` separately."""
    return _dlpack.to_dlpack(col.data[: col.length])


def from_dlpack(capsule, dtype=None) -> Column:
    """A 1-D DLPack tensor (a capsule or an object with ``__dlpack__``) as a
    Column on the tensor's own device, padded to its capacity bucket."""
    t = _dlpack.from_dlpack(capsule)
    if t.ndim != 1:
        raise ValueError("from_dlpack expects a 1-D tensor")
    dt = dtype or dtypes.from_numpy(np.dtype(str(t.dtype).replace("torch.", "")))
    n = t.shape[0]
    cap = bucket_capacity(max(n, 1))
    data = torch.zeros(cap, dtype=t.dtype, device=t.device)
    data[:n] = t
    return Column(dt, data, None, n)


def table_to_dlpack(tbl: Table):
    """A homogeneous numeric table as one 2-D f64 DLPack capsule, rows by
    columns (cudf::to_dlpack)."""
    n = tbl.num_rows
    mat = torch.stack([c.data[:n].to(torch.float64) for _, c in tbl], dim=1)
    return _dlpack.to_dlpack(mat)


def to_arrow_c(col: Column):
    """Arrow C Data Interface export: the (ArrowArray*, ArrowSchema*) cffi
    pointers and the ffi that owns them (nanoarrow analog)."""
    from pyarrow.cffi import ffi

    arr = col.to_arrow()
    c_schema = ffi.new("struct ArrowSchema*")
    c_array = ffi.new("struct ArrowArray*")
    arr._export_to_c(int(ffi.cast("uintptr_t", c_array)),
                     int(ffi.cast("uintptr_t", c_schema)))
    return c_array, c_schema, ffi


def from_arrow_c(c_array, c_schema, device=None) -> Column:
    """Import an array exported through the Arrow C Data Interface."""
    import pyarrow as pa
    from pyarrow.cffi import ffi

    arr = pa.Array._import_from_c(int(ffi.cast("uintptr_t", c_array)),
                                  int(ffi.cast("uintptr_t", c_schema)))
    return Column.from_arrow(arr, device)
