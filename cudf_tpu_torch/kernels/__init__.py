"""Hand-written Hopper kernels — counterparts of ``cudf_tpu/kernels/``.

* ``onehot_groupby`` — single-pass sum/count accumulator for
  low-cardinality groupby, in registers or per-warp shared memory
  (replaces the Pallas MXU one-hot kernel; the shape of libcudf's
  compute_single_pass_aggs.cuh).
* ``hashtable`` — linear-probing hash table for distinct-key build sides:
  a torch build into 16 B slots and a probe kernel that reads a slot with
  one vector load (replaces the Pallas VMEM probe; the cuco::static_set of
  distinct_hash_join.cu).
* ``launch_check`` — ``o = 2·x``, on no engine path: the counterpart of
  the launch-and-return repro ``benchmarks/pallas_tunnel_repro.py``.

The reference keeps its Pallas kernels behind an opt-in switch for a
TPU-only reason; here a CUDA tensor always takes the kernel, and a CPU
tensor takes the kernel's plain PyTorch version beside it.

Each CUDA source under ``csrc/`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, keyed by the
source's hash in ``build/`` (git-ignored), and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names) -> None:
    """Compile the named sources not built yet, one nvcc process per source,
    all started together."""
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
