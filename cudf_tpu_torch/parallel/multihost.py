"""Multi-process bootstrap and the cross-process partition exchange
(counterpart of ``cudf_tpu/parallel/multihost.py``).

  * ``initialize()``    — ``torch.distributed.init_process_group`` over a
                          ``TCPStore`` at the coordinator's address, from
                          arguments or the reference's environment
                          variables (``CUDF_TPU_COORDINATOR``,
                          ``CUDF_TPU_NUM_PROCESSES``, ``CUDF_TPU_PROCESS_ID``);
                          NCCL for CUDA shards, gloo for CPU shards
  * ``global_mesh()``   — a mesh over every process's shards
  * ``host_exchange``   — packed partitions addressed process to process
                          through the store (the reference uses jax's
                          key-value service); wire format ``ops/pack.py``

NCCL cannot put two ranks on one GPU, so ``initialize`` raises when two
ranks would share a card; it never falls back to gloo for CUDA tensors,
which would stage every exchange through the host unseen. Importing this
module initializes nothing and touches no device.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.table import Table


class _State:
    """The process's place in the job: set once by ``initialize``."""

    store = None
    device: Optional[torch.device] = None
    epoch = 0           # host_exchange calls: every rank calls in lockstep


_STATE = _State()
_TIMEOUT_S = 600    # joining the group, and the group's collectives


def _dist():
    import torch.distributed as tdist

    return tdist if tdist.is_available() and tdist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def rank_device() -> torch.device:
    """The device ``initialize`` gave this process."""
    if _STATE.device is None:
        raise RuntimeError("multihost.initialize() has not run in this process")
    return _STATE.device


def check_one_rank_per_device(placements: Sequence[str]) -> None:
    """``placements[r]`` is rank r's "host:cuda index". NCCL needs every
    rank on a card of its own: raise when two ranks share one."""
    seen = {}
    for r, p in enumerate(placements):
        if p in seen:
            raise ValueError(
                f"ranks {seen[p]} and {r} would share the GPU {p}: NCCL needs one GPU a "
                f"rank (use CPU shards with gloo, or one process a card)")
        seen[p] = r


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Join the job (idempotent). Arguments first, then the environment
    variables ``CUDF_TPU_COORDINATOR`` ("host:port"),
    ``CUDF_TPU_NUM_PROCESSES`` and ``CUDF_TPU_PROCESS_ID``; with neither
    an address nor a count the process stays single (the reference's
    fallback). Process 0 serves the ``TCPStore`` at the address.
    ``device`` is this process's shard device: ``None`` means CUDA (rank
    r takes card r modulo the visible count) and the NCCL backend; the CPU
    takes gloo."""
    from ..core.column import resolve_device

    if _dist() is not None:
        return
    coordinator_address = coordinator_address or os.environ.get("CUDF_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("CUDF_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["CUDF_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("CUDF_TPU_PROCESS_ID"):
        process_id = int(os.environ["CUDF_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator address, the process count "
                         "and this process's id")
    import torch.distributed as tdist

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    store = tdist.TCPStore(host, int(port), num_processes, process_id == 0, timeout)
    if dev.type == "cuda":
        store.set(f"cudf_tpu_place/{process_id}", f"{socket.gethostname()}:{dev.index}")
        keys = [f"cudf_tpu_place/{r}" for r in range(num_processes)]
        store.wait(keys, timeout)
        check_one_rank_per_device([store.get(k).decode() for k in keys])
        torch.cuda.set_device(dev)
    tdist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                             rank=process_id, world_size=num_processes, timeout=timeout)
    _STATE.store, _STATE.device = store, dev


def global_mesh(axis: str = "shards", n_devices: Optional[int] = None, devices=None):
    """A mesh over every process's shards (``spmd.make_mesh``)."""
    from .spmd import make_mesh

    if devices is None and _STATE.device is not None:
        devices = [_STATE.device]
    return make_mesh(n_devices, axis, devices)


# ---------------------------------------------------------------------------
# the host exchange: addressed blobs through the store. Each blob is written
# once by its sender and read once by its addressee, in chunks of at most
# _CHUNK_BYTES, its header last; every key is deleted once read (the
# reference's buffered rank-to-rank shuffler, partition_utils.hpp:50-82).
# ---------------------------------------------------------------------------

_CHUNK_BYTES = 2 << 20
_POLL_S = 0.002

def _to_blob(t: Table) -> bytes:
    from ..ops.pack import pack

    p = pack(t)
    return len(p.metadata).to_bytes(8, "little") + p.metadata + p.buffer


def _from_blob(b: bytes, device) -> Table:
    from ..ops.pack import PackedColumns, unpack

    mlen = int.from_bytes(b[:8], "little")
    return unpack(PackedColumns(b[8: 8 + mlen], b[8 + mlen:]), device)


# cumulative wall seconds this process spent inside host_exchange: the
# per-rank exchange-against-compute breakdown of a scaling run
EXCHANGE_SECONDS = 0.0


def host_exchange(partitions_by_dest: Sequence[Table], timeout_ms: int = 600_000,
                  spill_store=None) -> List[Table]:
    """Send ``partitions_by_dest[p]`` to process p; returns what every
    process addressed to this one, in sender order, on this process's
    partition's device. Its wall seconds add to ``EXCHANGE_SECONDS``.

    ``spill_store``: optional ``utils.native.PartitionStore``; received
    blobs stage through it (RAM, then disk) until every source is in.
    A blob that has not arrived ``timeout_ms`` after the call raises."""
    global EXCHANGE_SECONDS
    t0 = time.perf_counter()
    try:
        return _host_exchange(partitions_by_dest, timeout_ms, spill_store)
    finally:
        EXCHANGE_SECONDS += time.perf_counter() - t0


def _host_exchange(partitions_by_dest: Sequence[Table], timeout_ms: int,
                   spill_store) -> List[Table]:
    from concurrent.futures import ThreadPoolExecutor

    parts = list(partitions_by_dest)
    nproc, me = process_count(), process_index()
    assert len(parts) == nproc, (len(parts), nproc)
    if nproc == 1:
        return [parts[me]]
    store = _STATE.store
    if store is None:
        raise RuntimeError("host_exchange needs the store of multihost.initialize(); the "
                           "process group was started elsewhere")
    device = parts[me].device or _STATE.device
    pfx = f"cudf_tpu_x/{_STATE.epoch}"
    _STATE.epoch += 1

    def send(dest: int) -> None:
        b = _to_blob(parts[dest])
        nchunks = max(1, -(-len(b) // _CHUNK_BYTES))
        for ci in range(nchunks):
            store.set(f"{pfx}/{me}/{dest}/c{ci}",
                      b[ci * _CHUNK_BYTES: (ci + 1) * _CHUNK_BYTES])
        # the header last: its presence means every chunk is readable
        store.set(f"{pfx}/{me}/{dest}/hdr", f"{nchunks}:{len(b)}")

    def receive(src: int) -> bytes:
        hdr = f"{pfx}/{src}/{me}/hdr"
        nchunks, total = (int(x) for x in store.get(hdr).decode().split(":"))
        chunks = []
        for ci in range(nchunks):
            key = f"{pfx}/{src}/{me}/c{ci}"
            chunks.append(store.get(key))
            store.delete_key(key)
        store.delete_key(hdr)
        b = b"".join(chunks)
        if len(b) != total:
            raise RuntimeError(f"exchange from process {src}: {len(b)} of {total} bytes")
        return b

    out: List[Optional[Table]] = [None] * nproc
    staged: List[Optional[int]] = [None] * nproc
    out[me] = parts[me]
    deadline = time.monotonic() + timeout_ms / 1000
    with ThreadPoolExecutor(max_workers=max(2, min(nproc - 1, 4))) as pool:
        sends = [pool.submit(send, d) for d in range(nproc) if d != me]
        pending = [s for s in range(nproc) if s != me]
        # unpack in arrival order: a slow source holds back no earlier one
        while pending:
            ready = [s for s in pending if store.check([f"{pfx}/{s}/{me}/hdr"])]
            for src in ready:
                b = receive(src)
                if spill_store is not None:
                    staged[src] = spill_store.put(np.frombuffer(b, np.uint8))
                else:
                    out[src] = _from_blob(b, device)
                pending.remove(src)
            if pending and not ready:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"host_exchange: nothing from processes {pending} "
                                       f"after {timeout_ms} ms")
                time.sleep(_POLL_S)
        for f in sends:
            f.result()
    if spill_store is not None:
        for i, pid in enumerate(staged):
            if pid is not None:
                out[i] = _from_blob(spill_store.get(pid).tobytes(), device)
                spill_store.drop(pid)
    return out
