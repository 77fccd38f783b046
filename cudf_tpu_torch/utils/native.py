"""ctypes bindings of the host partition store (counterpart of
``cudf_tpu/utils/native.py``).

``csrc/partition_store.cpp`` (the port's copy of
``native/partition_store.cpp``) is compiled by ``g++`` at first use into
the git-ignored ``kernels/build/``, keyed by the source's hash as the CUDA
sources are, and loaded with ctypes. A failed build raises with the
compiler's output; the reference's loader returns None and falls back to
numpy, which the port does not copy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "partition_store.cpp"
BUILD = Path(__file__).resolve().parent.parent / "kernels" / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
PROTOTYPES = {
    "ps_create": ([_U64, ctypes.c_char_p], _P),
    "ps_destroy": ([_P], None),
    "ps_put": ([_P, _U64, _P, _U64], ctypes.c_int),
    "ps_get": ([_P, _U64, _P, _U64], _I64),
    "ps_size": ([_P, _U64], _I64),
    "ps_drop": ([_P, _U64], ctypes.c_int),
    "ps_stats": ([_P, ctypes.POINTER(_U64)], None),
    "pack_bits": ([_P, _U64, _P], None),
    "unpack_bits": ([_P, _U64, _P], None),
}

_LIB: Optional[ctypes.CDLL] = None


def build(src: Path = SRC) -> Path:
    """Compile ``src`` with g++ (once per source version); the library's
    path. Raises RuntimeError with the compiler's output when it fails."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the partition store cannot be built")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load() -> ctypes.CDLL:
    """The partition store's library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in PROTOTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = lib
    return _LIB


class PartitionStore:
    """Budgeted host buffer store with LRU spill to files in ``spill_dir``
    (a new temporary directory by default, removed by ``close``)."""

    def __init__(self, budget_bytes: int = 4 << 30, spill_dir: Optional[str] = None):
        self._own_dir = spill_dir is None
        self.spill_dir = tempfile.mkdtemp(prefix="cudf_tpu_torch_spill_") \
            if spill_dir is None else spill_dir
        os.makedirs(self.spill_dir, exist_ok=True)
        self._lib = load()
        self._h = self._lib.ps_create(budget_bytes, self.spill_dir.encode())
        self._next = 0
        self._meta: dict = {}

    def put(self, arr: np.ndarray) -> int:
        """Copy ``arr`` into the store; its id."""
        arr = np.ascontiguousarray(arr)
        pid = self._next
        self._next += 1
        if self._lib.ps_put(self._h, pid, arr.ctypes.data, arr.nbytes) != 0:
            raise RuntimeError(f"partition store: put of {arr.nbytes} bytes failed")
        self._meta[pid] = (arr.dtype, arr.shape)
        return pid

    def get(self, pid: int) -> np.ndarray:
        """A copy of buffer ``pid``, read back from disk if it was spilled."""
        dtype, shape = self._meta[pid]
        out = np.empty(shape, dtype)
        got = self._lib.ps_get(self._h, pid, out.ctypes.data, out.nbytes)
        if got != out.nbytes:
            raise RuntimeError(f"partition store: get of buffer {pid} failed ({got})")
        return out

    def drop(self, pid: int) -> None:
        self._lib.ps_drop(self._h, pid)
        self._meta.pop(pid, None)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.ps_stats(self._h, out)
        return {"resident_bytes": out[0], "n_buffers": out[1],
                "spill_count": out[2], "unspill_count": out[3]}

    def close(self) -> None:
        """Free every buffer and spill file (and the directory, when the
        store made it)."""
        if self._h is not None:
            self._lib.ps_destroy(self._h)
            self._h = None
            self._meta.clear()
            if self._own_dir:
                shutil.rmtree(self.spill_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


def pack_bits(bools: np.ndarray) -> np.ndarray:
    """bool[n] -> Arrow LSB bitmap bytes."""
    b = np.ascontiguousarray(bools, dtype=np.uint8)
    out = np.zeros(((len(b) + 7) // 8,), np.uint8)
    load().pack_bits(b.ctypes.data, len(b), out.ctypes.data)
    return out


def unpack_bits(bitmap: np.ndarray, n: int) -> np.ndarray:
    """Arrow LSB bitmap bytes -> bool[n]."""
    bm = np.ascontiguousarray(bitmap, dtype=np.uint8)
    if len(bm) < (n + 7) // 8:
        raise ValueError(f"a bitmap of {len(bm)} bytes holds fewer than {n} bits")
    out = np.zeros((n,), np.uint8)
    load().unpack_bits(bm.ctypes.data, n, out.ctypes.data)
    return out.astype(bool)
