"""Hand-written Hopper kernels — counterparts of ``cudf_tpu/kernels/``.

* ``onehot_groupby`` — single-pass sum/count accumulator for
  low-cardinality groupby, in registers or per-warp shared memory
  (replaces the Pallas MXU one-hot kernel; the shape of libcudf's
  compute_single_pass_aggs.cuh).
* ``hashtable`` — linear-probing hash table for distinct-key build sides:
  an insert kernel that builds the 16 B slots in one launch with no probe
  cap (it replaces no Pallas kernel: the reference builds with XLA
  scatter rounds, which give up after 16 probes; here those rounds remain
  the CPU's build) and a probe kernel that reads a slot with one vector
  load (replaces the Pallas VMEM probe; the cuco::static_set of
  distinct_hash_join.cu).
* ``launch_check`` — ``o = 2·x``, on no engine path: the counterpart of
  the launch-and-return repro ``benchmarks/pallas_tunnel_repro.py``.
* ``segment_reduce`` — the per-segment sum/prod/min/max of every groupby
  lane over key-sorted rows: a reduce-by-key with no atomics. It replaces
  no Pallas kernel (the reference leaves segment reductions to XLA); it
  replaces torch's ``scatter_reduce_``, one atomic a row.
* ``dense_groupby`` — float64 and int64 sums and counts of several columns
  by keys that pack into at most 11 code bits, in one pass with no sort,
  in per-thread or per-warp copies in shared memory. It replaces no
  Pallas kernel (the reference sorts for these sums); it takes the sort
  lane's place where the group ids are dense already.

The reference keeps its Pallas kernels behind an opt-in switch for a
TPU-only reason; here a CUDA tensor always takes the kernel, and a CPU
tensor takes the kernel's plain PyTorch version beside it.

Each CUDA source under ``csrc/`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, keyed by the
source's hash in ``build/`` (git-ignored), and loaded with ctypes. Each C
entry point's prototype is set once, when the library is loaded
(``PROTOTYPES``), and the bound function is cached (``entry``): a launch
pays one ctypes call, not a prototype rebuild.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
# -cudart=shared: launch through the CUDA runtime torch has already loaded,
# not a second, static copy of it in each library (nvcc's default), whose
# launches reached the device later than torch's own
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-cudart=shared"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (argtypes, restype) of every C entry point, by source
PROTOTYPES = {
    "launch_check": {"launch_check_double": ([_P, _P, _LL, _P], _I)},
    "hashtable_probe": {"hashtable_probe": ([_P] * 4 + [_LL, _LL, _I, _P], _I),
                        "hashtable_insert": ([_P] * 4 + [_LL, _LL, _P, _P], _I)},
    "onehot_groupby": {
        "onehot_groupby_blocks": ([_LL, _I, _I, _I, ctypes.POINTER(_I)], _I),
        "onehot_groupby_sum_count": ([_P] * 5 + [_LL, _I, _I, _I, _I, _P], _I)},
    "segment_reduce": {
        "segment_reduce_scratch": ([_LL], _LL),
        "segment_reduce": ([_P, _P, _LL, _LL, _I, _I] + [_P] * 6, _I)},
    "dense_groupby": {
        "dense_groupby_blocks": ([_LL, _I, _I, _I, ctypes.POINTER(_I)], _I),
        "dense_groupby_sums": ([_P, _P, _P, _I, _P, _P, _I, _LL] + [_I] * 4 + [_P] * 3, _I)},
}


class KernelError(RuntimeError):
    """A kernel that failed to build or to launch."""


_LIBS: dict = {}
_ENTRIES: dict = {}  # (source, entry point) -> bound ctypes function
# one build at a time in a process: a background prewarm and a first launch
# would otherwise both compile a source into the same temporary file
_BUILD_LOCK = threading.Lock()


def sources() -> list:
    """The names of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names) -> None:
    """Compile the named sources not built yet, one nvcc process per source,
    all started together."""
    with _BUILD_LOCK:
        _build(names)


def _build(names) -> None:
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
        raise KernelError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source version) and load ``csrc/<name>.cu``, binding
    the prototypes of its entry points."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        try:
            lib = ctypes.CDLL(str(_target(name)))
            fns = {fn_name: (getattr(lib, fn_name), proto)
                   for fn_name, proto in PROTOTYPES.get(name, {}).items()}
        except (OSError, AttributeError) as e:  # a library that cannot load, a missing symbol
            raise KernelError(f"cannot load the {name} kernel library: {e}") from e
        for fn_name, (fn, (argtypes, restype)) in fns.items():
            fn.argtypes, fn.restype = argtypes, restype
            _ENTRIES[(name, fn_name)] = fn
        _LIBS[name] = lib
    return lib


def entry(name: str, fn_name: str):
    """The bound C entry point ``fn_name`` of ``csrc/<name>.cu``."""
    fn = _ENTRIES.get((name, fn_name))
    if fn is None:
        load_library(name)
        fn = _ENTRIES[(name, fn_name)]
    return fn


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for a launch; no context switch
    when it already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_of(dev: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``dev``'s current stream, read as torch's
    own generated kernels read it (``torch._inductor``'s
    ``get_raw_stream``): ``torch.cuda.current_stream().cuda_stream`` first
    builds a Python ``Stream`` object, which costs a launch several times
    what the ctypes call does (``chip_smoke.py``'s launch check times both)."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if dev.index is None else dev.index)
