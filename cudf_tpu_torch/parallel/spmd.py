"""Distributed execution over a mesh of shards: sharded tables, the hash
shuffle, and the distributed groupby, joins, sort, distinct and
elementwise stages (counterpart of ``cudf_tpu/parallel/spmd.py``).

The reference runs one jitted shard_map program per operation over a
``jax.sharding.Mesh`` and exchanges fixed (n_shards, bucket) blocks with
``lax.all_to_all``. Here:

  jax Mesh                  ->  ``Mesh``: n shards, each shard's torch
                                device and the process that owns it
  shard_map body            ->  the port's own op on each local shard's
                                Table (``ops.groupby.groupby_aggregate``,
                                ``ops.join.join``, ``ops.sorting``), so
                                each shard runs the one-hot and probe
                                kernels the single-table path runs
  lax.all_to_all            ->  a communicator: in-process (every shard
                                local; a block moves by slicing, or by
                                ``.to()`` to another device) or a
                                ``torch.distributed`` process group
                                (``all_to_all_single`` with split sizes)
  lax.all_gather / psum     ->  the communicator's ``all_gather`` and
                                ``allreduce``

An exchange sizes every receive buffer exactly from the n x n matrix of
row counts, read to the host once (the reference's one sync,
``int(overflow[0])``). Capacity buckets are a TPU mechanism and are not
copied, so no row ever overflows: ``shuffle_by_key`` returns overflow 0
and its ``bucket`` and ``auto_retry`` arguments have nothing to do.

A shard's rows go to ``hash(keys) % n``. The keys are hashed as
``plan_executor._shuffle_key`` gives them: a non-null int64 or f64 key as
it is, so such a row lands on the reference's shard; a string by its value,
not by its dictionary code; narrower types widened and a null as 0. The
reference hashes a string's code, so its ``dist_join`` of two tables whose
dictionaries differ loses matches and pairs wrong rows (pinned by a test);
here the two sides meet and the local join unifies their dictionaries.

The reference catches every exception of a traced ``dist_elementwise``
and replays the stage on the host (its host-only string ops cannot be
traced). The port has no trace: each shard is evaluated on its own device
and nothing is caught, so ``DIST_FALLBACK_COUNTS`` stays empty; it and
``note_dist_fallback`` are kept for the reference's interface.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.column import Column, resolve_device
from ..core.dtypes import Kind
from ..core.stats import ColStats
from ..core.table import Table
from ..utils.padding import bucket_capacity


# ---------------------------------------------------------------------------
# communicators
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class InProcessComm:
    """Every shard lives in this process: a block moves by slicing, or by
    ``.to(device)`` when its destination shard sits on another device."""

    world, rank = 1, 0

    def all_to_all(self, mesh: "Mesh", sends: List[Dict[str, torch.Tensor]],
                   counts: List[List[int]]) -> List[Dict[str, torch.Tensor]]:
        """``sends[s][name]`` holds shard s's rows ordered by destination,
        ``counts[s][d]`` of them for shard d; returns for each shard d its
        received rows, from every source in shard order."""
        n = mesh.size
        out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
        for name in sends[0]:
            blocks = [torch.split(sends[s][name], counts[s]) for s in range(n)]
            for d in range(n):
                dev = mesh.devices[d]
                out[d][name] = torch.cat([blocks[s][d].to(dev) for s in range(n)])
        return out

    def all_gather(self, mesh: "Mesh", values: List[torch.Tensor]) -> List[torch.Tensor]:
        return list(values)

    def allreduce(self, mesh: "Mesh", values: List[float], op: str) -> List[float]:
        return list(values)


class ProcessGroupComm:
    """Shards spread over the processes of ``torch.distributed``'s default
    group (``multihost.initialize``), the same number in each; process p
    owns shards p·k .. p·k + k - 1. Each exchange is one
    ``all_to_all_single`` of the count blocks, then one a column with the
    exact split sizes; blocks between two shards of one process are this
    rank's own split, which the backend copies in place. Tensors cross on
    the first local shard's device: a CUDA device under NCCL, the CPU
    under gloo."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def _device(self, mesh: "Mesh") -> torch.device:
        return mesh.devices[mesh.local_shards()[0]]

    def all_to_all(self, mesh: "Mesh", sends: List[Dict[str, torch.Tensor]],
                   counts: List[List[int]]) -> List[Dict[str, torch.Tensor]]:
        """``sends[i]`` and ``counts[i]`` (over all n destinations) for
        local shard i; returns each local shard's received rows, from every
        source shard in shard order."""
        import torch.distributed as tdist

        k, w, dev = mesh.local_count, self.world, self._device(mesh)
        # send_counts[q][i][j]: rows of my local shard i for q's local shard j
        send_counts = torch.tensor([[[counts[i][q * k + j] for j in range(k)]
                                     for i in range(k)] for q in range(w)],
                                   dtype=torch.int64, device=dev).view(-1)
        recv_counts = torch.empty_like(send_counts)
        tdist.all_to_all_single(recv_counts, send_counts)
        rc = recv_counts.view(w, k, k).tolist()
        in_splits = [sum(counts[i][q * k + j] for i in range(k) for j in range(k))
                     for q in range(w)]
        out_splits = [sum(rc[p][i][j] for i in range(k) for j in range(k)) for p in range(w)]
        out: List[Dict[str, torch.Tensor]] = [{} for _ in range(k)]
        for name in sends[0]:
            blocks = [torch.split(_wire(sends[i][name]).to(dev), counts[i]) for i in range(k)]
            send = torch.cat([blocks[i][q * k + j] for q in range(w) for j in range(k)
                              for i in range(k)])
            recv = send.new_empty((sum(out_splits),))
            tdist.all_to_all_single(recv, send, out_splits, in_splits)
            from_p = torch.split(recv, out_splits)
            pieces = [torch.split(from_p[p], [rc[p][i][j] for j in range(k) for i in range(k)])
                      for p in range(w)]
            for j in range(k):
                got = torch.cat([pieces[p][j * k + i] for p in range(w) for i in range(k)])
                if sends[0][name].dtype == torch.bool:
                    got = got.to(torch.bool)
                out[j][name] = got.to(mesh.devices[mesh.local_shards()[j]])
        return out

    def all_gather(self, mesh: "Mesh", values: List[torch.Tensor]) -> List[torch.Tensor]:
        import torch.distributed as tdist

        dev = self._device(mesh)
        mine = torch.stack([v.to(dev) for v in values])
        got = [torch.empty_like(mine) for _ in range(self.world)]
        tdist.all_gather(got, mine)
        return [row for g in got for row in g]

    def allreduce(self, mesh: "Mesh", values: List[float], op: str) -> List[float]:
        import torch.distributed as tdist

        t = torch.tensor(values, dtype=torch.float64, device=self._device(mesh))
        tdist.all_reduce(t, {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX,
                             "min": tdist.ReduceOp.MIN}[op])
        return t.tolist()


@dataclasses.dataclass
class MeshStats:
    """What the mesh's exchanges moved and where the time went: bytes that
    left their shard, and (when ``Mesh.timing`` is on, which synchronizes
    the devices around each step) seconds in exchanges (a shuffle's hash
    included) and in shard-local ops."""

    exchanges: int = 0
    exchange_bytes: int = 0
    exchange_s: float = 0.0
    local_s: float = 0.0


class Mesh:
    """``size`` shards on one axis: shard s on ``devices[s]``, owned by
    process ``processes[s]``. With several shards on one device the mesh is
    the reference's virtual mesh on one card."""

    def __init__(self, devices: Sequence[torch.device], processes: Sequence[int],
                 axis: str, comm):
        self.devices = tuple(devices)
        self.processes = tuple(processes)
        self.axis = axis
        self.comm = comm
        self.local_count = sum(p == comm.rank for p in self.processes)
        self.stats = MeshStats()
        self.timing = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    def local_shards(self) -> List[int]:
        return [s for s, p in enumerate(self.processes) if p == self.comm.rank]

    def reset_stats(self) -> None:
        self.stats = MeshStats()

    @contextlib.contextmanager
    def timed(self, what: str):
        """Add the block's seconds to ``stats.<what>_s`` when ``timing``
        is on (the local devices are synchronized on both sides)."""
        if not self.timing:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            attr = f"{what}_s"
            setattr(self.stats, attr, getattr(self.stats, attr) + time.perf_counter() - t0)

    def _sync(self) -> None:
        for d in {self.devices[s] for s in self.local_shards()}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def __repr__(self) -> str:
        return (f"Mesh({self.axis}: {self.size} shards, devices "
                f"{[str(d) for d in self.devices]}, processes {list(self.processes)})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "shards",
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards (default: one a device).

    ``devices`` are this process's devices; ``None`` means every visible
    CUDA device, and raises when there is none (under a process group of
    several processes: the one card ``multihost.initialize`` gave this
    rank). Shards take the devices round-robin, so 8 shards on one card is
    the reference's 8-device virtual mesh. Under a process group of w
    processes, ``n_devices`` counts all shards and must divide by w; each
    process owns a contiguous block of n / w of them, and talks to the
    others through ``ProcessGroupComm``."""
    from . import multihost

    rank, world = multihost.process_index(), multihost.process_count()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices=['cpu']")
        if world > 1:
            devices = [multihost.rank_device()]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if n_devices is None:
        k = len(devices)
    else:
        if n_devices % world:
            raise ValueError(f"{n_devices} shards do not divide over {world} processes")
        k = n_devices // world
    shard_devices = [devices[(s % k) % len(devices)] for s in range(k * world)]
    processes = [s // k for s in range(k * world)]
    comm = ProcessGroupComm(rank, world) if world > 1 else InProcessComm()
    return Mesh(shard_devices, processes, axis, comm)


# ---------------------------------------------------------------------------
# sharded tables
# ---------------------------------------------------------------------------

def _on(tbl: Table, device: torch.device) -> Table:
    """``tbl`` with every column on ``device``."""
    if all(c.device == device for c in tbl.columns):
        return tbl
    out = {}
    for name, c in tbl:
        col = Column(c.dtype, c.data.to(device),
                     None if c.validity is None else c.validity.to(device),
                     c.length, c.dictionary)
        col.stats = c.stats
        out[name] = col
    return Table(out)


def _unify(tables: List[Table]) -> List[Table]:
    """The tables with each string column recoded onto one dictionary."""
    from ..ops.strings import unify_dictionaries

    if not tables:
        return tables
    out = [dict(t._columns) for t in tables]
    for name in tables[0].names:
        if tables[0][name].dtype.is_string:
            for d, c in zip(out, unify_dictionaries([t[name] for t in tables])):
                d[name] = c
    return [Table(d) for d in out]


@dataclasses.dataclass
class ShardedTable:
    """A logically single table, row-partitioned over a mesh axis: one
    port ``Table`` a local shard, on that shard's device. String columns
    share one dictionary across the shards."""

    mesh: Mesh
    axis: str
    names: List[str]
    tables: List[Table]           # this process's shards, in shard order
    dtypes: Dict[str, dt.DType]
    dictionaries: Dict[str, Optional[np.ndarray]]

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def lengths(self) -> List[int]:
        """Rows of this process's shards."""
        return [t.num_rows for t in self.tables]

    @classmethod
    def _of(cls, mesh: Mesh, axis: str, tables: List[Table]) -> "ShardedTable":
        tables = [_on(t, mesh.devices[s]) for s, t in zip(mesh.local_shards(), _unify(tables))]
        first = tables[0]
        return cls(mesh, axis, list(first.names), tables,
                   {n: first[n].dtype for n in first.names},
                   {n: first[n].dictionary for n in first.names})

    @classmethod
    def from_tables(cls, tables: Sequence[Table], mesh: Mesh, axis: str = "shards"):
        """One table a shard (all ``n_shards`` of them); string dictionaries
        are unified. A process keeps its own shards."""
        assert len(tables) == mesh.size, (len(tables), mesh.size)
        tables = _unify(list(tables))
        return cls._of(mesh, axis, [tables[s] for s in mesh.local_shards()])

    @classmethod
    def from_process_local(cls, tables: Sequence[Table], mesh: Mesh,
                           axis: str = "shards", cap: Optional[int] = None):
        """Each process gives the tables of its own shards only. String
        dictionaries are unified across the processes too (one gather of
        the dictionaries), so codes mean the same on every shard. ``cap``
        is the reference's per-shard capacity; shards here hold exactly
        their rows, so it is not needed."""
        tables = list(tables)
        assert len(tables) == mesh.local_count, (len(tables), mesh.local_count)
        if mesh.comm.world > 1:
            tables = _unify_across_processes(tables)
        return cls._of(mesh, axis, tables)

    def local_tables(self) -> List[Table]:
        """This process's shards."""
        return list(self.tables)

    def to_tables(self) -> List[Table]:
        """Every shard (they must all be local: one process)."""
        assert len(self.tables) == self.n_shards, "to_tables needs every shard local"
        return list(self.tables)

    def concat_to_table(self) -> Table:
        """The shards' rows in shard order, as one table on the first
        shard's device."""
        from ..ops.copying import concatenate_tables

        dev = self.mesh.devices[self.mesh.local_shards()[0]]
        return concatenate_tables([_on(t, dev) for t in self.to_tables()])


def _unify_across_processes(tables: List[Table]) -> List[Table]:
    """Recode every string column onto the union of all processes'
    dictionaries (gathered with ``all_gather_object``)."""
    import torch.distributed as tdist

    from ..ops.strings import _remap_codes

    tables = _unify(tables)
    first = tables[0]
    strings = [n for n in first.names if first[n].dtype.is_string]
    if not strings:
        return tables
    mine = [np.asarray(first[n].dictionary if first[n].dictionary is not None else [],
                       dtype=str) for n in strings]
    got: List[list] = [None] * tdist.get_world_size()
    tdist.all_gather_object(got, [list(d) for d in mine])
    out = [dict(t._columns) for t in tables]
    for i, n in enumerate(strings):
        merged = np.unique(np.concatenate([np.asarray(g[i], dtype=str) for g in got]))
        remap = np.searchsorted(merged, mine[i]).astype(np.int32)
        for d, t in zip(out, tables):
            d[n] = _remap_codes(t[n], remap, merged)
    return [Table(d) for d in out]


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _valid_name(name: str) -> str:
    return name + "\0valid"


def _exact(tbl: Table, masked: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The table's columns (and, for ``masked`` columns, validities) cut
    to its rows."""
    n = tbl.num_rows
    out = {}
    for name, c in tbl:
        out[name] = c.data[:n]
        if name in masked:
            out[_valid_name(name)] = (c.validity[:n] if c.validity is not None
                                      else torch.ones(n, dtype=torch.bool, device=c.device))
    return out


def _bucketize(arrays: Dict[str, torch.Tensor], pid: torch.Tensor, n_parts: int):
    """Rows reordered by destination (stable: row order inside a
    destination) and the count for each destination."""
    order = torch.sort(pid, stable=True).indices
    counts = torch.bincount(pid, minlength=n_parts)
    return {k: v[order] for k, v in arrays.items()}, counts


def _compact_received(recv: Dict[str, torch.Tensor], template: Table) -> Table:
    """A received shard's exact arrays as a padded Table, with the
    template's dtypes and dictionaries."""
    names = [n for n in recv if not n.endswith("\0valid")]
    n = recv[names[0]].shape[0] if names else 0
    cap = bucket_capacity(n)
    cols = {}
    for name in names:
        d = recv[name]
        data = torch.zeros(cap, dtype=d.dtype, device=d.device)
        data[:n] = d
        v = recv.get(_valid_name(name))
        validity = None
        if v is not None:
            validity = torch.zeros(cap, dtype=torch.bool, device=d.device)
            validity[:n] = v
        src = template[name] if name in template else None
        cols[name] = Column(src.dtype if src is not None else dt.int64, data, validity, n,
                            src.dictionary if src is not None else None)
    return Table(cols)


def _masked_names(st_tables: List[Table], mesh: Mesh) -> List[str]:
    """Columns with a validity mask on any shard of any process."""
    names = st_tables[0].names
    flags = [float(any(t[n].validity is not None for t in st_tables)) for n in names]
    flags = mesh.comm.allreduce(mesh, flags, "max")
    return [n for n, f in zip(names, flags) if f]


def _exchange(st: ShardedTable, pids: List[torch.Tensor],
              extra: Optional[List[Dict[str, torch.Tensor]]] = None) -> List[Table]:
    """Send each local shard's rows to the shard ``pids`` names for them;
    ``extra`` arrays (one dict a shard, one value a row) ride along and
    come back as int64 columns of the received tables."""
    mesh = st.mesh
    masked = _masked_names(st.tables, mesh)
    with mesh.timed("exchange"):
        sends, counts = [], []
        for i, (t, pid) in enumerate(zip(st.tables, pids)):
            arrays = _exact(t, masked)
            if extra is not None:
                arrays.update(extra[i])
            s, c = _bucketize(arrays, pid.to(torch.int64), mesh.size)
            sends.append(s)
            counts.append(c)
        # the one host read: every shard's counts at once
        counts = torch.stack([c.to(counts[0].device) for c in counts]).tolist()
        local = mesh.local_shards()
        row_bytes = sum(v.element_size() for v in sends[0].values())
        moved = sum(c for i, row in zip(local, counts) for d, c in enumerate(row) if d != i)
        mesh.stats.exchanges += 1
        mesh.stats.exchange_bytes += moved * row_bytes
        recv = mesh.comm.all_to_all(mesh, sends, counts)
        template = st.tables[0]
        return [_compact_received(r, template) for r in recv]


def shuffle_by_key(st: ShardedTable, keys: Sequence[str],
                   bucket: Optional[int] = None,
                   auto_retry: bool = True) -> Tuple[ShardedTable, int]:
    """Hash-shuffle rows so that equal keys land on one shard; returns
    (shuffled table, overflow rows). Each shard receives its rows from
    every source shard in shard order, each source's in row order. The
    receive buffers are sized exactly, so the overflow is always 0 and
    ``bucket``/``auto_retry`` (the reference's block size and its retry
    with doubled blocks) have nothing to do."""
    from ..ops.hashing import partition_ids
    from .plan_executor import _shuffle_key

    with st.mesh.timed("exchange"):
        pids = [partition_ids([_shuffle_key(t[k]) for k in keys], st.n_shards)[: t.num_rows]
                for t in st.tables]
    return ShardedTable._of(st.mesh, st.axis, _exchange(st, pids)), 0


def _local(st: ShardedTable, fn, tables: Optional[List[Table]] = None) -> ShardedTable:
    """``fn`` over each local shard's table, as a ShardedTable."""
    with st.mesh.timed("local"):
        out = [fn(t) for t in (st.tables if tables is None else tables)]
    return ShardedTable._of(st.mesh, st.axis, out)


# ---------------------------------------------------------------------------
# distributed operators: shuffle, then the exact local op on each shard
# ---------------------------------------------------------------------------

def dist_groupby(st: ShardedTable, keys: Sequence[str], aggs,
                 bucket: Optional[int] = None, dropna_keys: bool = False) -> ShardedTable:
    """Exact distributed groupby: hash-shuffle the keys, then each shard's
    ``groupby_aggregate`` (every agg kind, nunique/median/quantile
    included: a key's rows are all on one shard). Null keys form their
    own group, as in the reference's shard body, unless ``dropna_keys``
    (the in-memory executor's GroupBy, which ``execute_spmd`` must equal)."""
    from ..ops.groupby import groupby_aggregate

    shuffled, overflow = shuffle_by_key(st, keys, bucket)
    assert overflow == 0
    return _local(shuffled, lambda t: groupby_aggregate(t, list(keys), list(aggs),
                                                        dropna_keys=dropna_keys))


# The reference's dist joins rename a right clash only. A shard's join is
# unordered, libcudf's contract and the in-memory executor's, so an inner
# join may build its hash table on its smaller side.
_SUFFIXES = ("", "_y")


def dist_join(left: ShardedTable, right: ShardedTable,
              left_on: Sequence[str], right_on: Sequence[str],
              how: str = "inner", bucket: Optional[int] = None) -> ShardedTable:
    """Shuffle-shuffle equi-join: both sides co-partitioned by their keys'
    hash, then each shard's ``join``. A right join is a swapped left join
    with the left frame's column order restored; a full join's unmatched
    right rows are a local decision once the sides are co-partitioned."""
    from ..ops.join import join

    if how in ("semi", "anti"):
        return dist_semi_anti_join(left, right, left_on, right_on, how, bucket)
    if how == "right":
        sw = dist_join(right, left, list(right_on), list(left_on), "left", bucket)
        key_same = {ln for ln, rn in zip(left_on, right_on) if ln == rn}
        lmapped = [n if (n in key_same or n not in set(right.names)) else n + "_y"
                   for n in left.names]
        order = lmapped + [n for n in sw.names if n not in set(lmapped)]
        assert set(order) == set(sw.names), (order, sw.names)
        return ShardedTable._of(sw.mesh, sw.axis, [t.select(order) for t in sw.tables])
    if how not in ("inner", "left", "full"):
        raise ValueError(f"unknown join type {how!r}")
    sl, ovl = shuffle_by_key(left, left_on, bucket)
    sr, ovr = shuffle_by_key(right, right_on, bucket)
    assert ovl == 0 and ovr == 0
    pairs = iter(sr.tables)
    return _local(sl, lambda lt: join(lt, next(pairs), list(left_on), list(right_on),
                                      how, suffixes=_SUFFIXES, ordered=False))


def _replicas(tbl: Table, mesh: Mesh) -> Dict[torch.device, Table]:
    """``tbl`` copied once to each device of this process's shards."""
    return {d: _on(tbl, d) for d in {mesh.devices[s] for s in mesh.local_shards()}}


def broadcast_join(left: ShardedTable, right_small: Table,
                   left_on: Sequence[str], right_on: Sequence[str],
                   how: str = "inner") -> ShardedTable:
    """The small side replicated to every shard's device, joined with each
    left shard; string keys are unified by the local join."""
    from ..ops.join import join

    reps = _replicas(right_small, left.mesh)
    return _local(left, lambda lt: join(lt, reps[lt.device], list(left_on), list(right_on),
                                        how, suffixes=_SUFFIXES, ordered=False))


def dist_semi_anti_join(left: ShardedTable, right: Optional[ShardedTable],
                        left_on: Sequence[str], right_on: Sequence[str],
                        how: str, bucket: Optional[int] = None,
                        broadcast_right: Optional[Table] = None) -> ShardedTable:
    """semi/anti join: the left rows whose key has (semi) or lacks (anti) a
    match. With ``broadcast_right`` the right side is replicated and the
    left is not shuffled; otherwise both sides are co-partitioned."""
    from ..ops.join import join

    assert how in ("semi", "anti")
    if broadcast_right is not None:
        reps = _replicas(broadcast_right, left.mesh)
        return _local(left, lambda lt: join(lt, reps[lt.device], list(left_on),
                                            list(right_on), how))
    sl, _ = shuffle_by_key(left, left_on, bucket)
    sr, _ = shuffle_by_key(right, right_on, bucket)
    pairs = iter(sr.tables)
    return _local(sl, lambda lt: join(lt, next(pairs), list(left_on), list(right_on), how))


# ---------------------------------------------------------------------------
# the distributed sort
# ---------------------------------------------------------------------------

def _shard_stats(c: Column) -> List[float]:
    """(vmin, vmax, n_valid, nonint, anynan, anynull) of one shard's
    column over its rows, as the reference's ``_global_stats_kernel``
    computes them in f64."""
    d = c.data[: c.length].to(torch.float64)
    valid = (torch.ones_like(d, dtype=torch.bool) if c.validity is None
             else c.validity[: c.length])
    isnan = torch.isnan(d)
    ok = valid & ~isnan
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=d.device)
    return torch.stack([
        torch.where(ok, d, inf).min() if d.numel() else inf,
        torch.where(ok, d, -inf).max() if d.numel() else -inf,
        ok.sum().to(torch.float64),
        (ok & (torch.floor(d) != d)).any().to(torch.float64),
        (valid & isnan).any().to(torch.float64),
        (~valid).any().to(torch.float64)]).tolist()


def _global_key_stats(st: ShardedTable, name: str) -> ColStats:
    """ColStats of one column over every shard (the reference's
    ``_global_key_stats``; one host read a shard, one reduction across
    processes)."""
    if st.dtypes[name].is_string:
        nd = len(st.dictionaries[name]) if st.dictionaries[name] is not None else 0
        masked = name in _masked_names(st.tables, st.mesh)
        return ColStats(0.0, float(max(nd - 1, 0)), True, False, masked, 1)
    per = [_shard_stats(t[name]) for t in st.tables]
    vmin = st.mesh.comm.allreduce(st.mesh, [min(p[0] for p in per)], "min")[0]
    vmax, nonint, anynan, anynull = st.mesh.comm.allreduce(
        st.mesh, [max(p[i] for p in per) for i in (1, 3, 4, 5)], "max")
    n_valid = st.mesh.comm.allreduce(st.mesh, [sum(p[2] for p in per)], "sum")[0]
    return stats_of(vmin, vmax, n_valid, nonint, anynan, anynull)


def stats_of(vmin, vmax, n_valid, nonint, anynan, anynull) -> ColStats:
    """ColStats from the reductions of ``_shard_stats`` over every shard:
    integral only within 2^52, where f64 holds every integer."""
    if n_valid == 0:
        return ColStats(0.0, 0.0, True, bool(anynan), bool(anynull), 0)
    integral = (not nonint) and abs(vmin) < 2 ** 52 and abs(vmax) < 2 ** 52
    return ColStats(vmin, vmax, integral, bool(anynan), bool(anynull), int(n_valid))


def sort_plan(dtypes: Sequence[dt.DType], masked: Sequence[bool],
              stats: Sequence[ColStats]):
    """Each key's (kind, width) for ``build_order_words``: a narrow
    integral code when the global stats allow one, else the dtype's
    order operands with a null flag where the column is masked."""
    plan = []
    for kd, m, stt in zip(dtypes, masked, stats):
        w = stt.code_width()
        nf = 1 if m else 0
        if w is not None and w <= 40:
            plan.append(("code", w))
        elif kd.kind == Kind.FLOAT and kd.bits <= 32:
            plan.append(("f32", nf + 32))
        elif kd.kind in (Kind.INT, Kind.UINT, Kind.TIMESTAMP, Kind.DURATION, Kind.DECIMAL):
            plan.append(("i64", nf + 64))
        elif kd.kind == Kind.FLOAT:
            plan.append(("f64", nf + 67))
        else:
            raise TypeError(f"cannot dist-sort dtype {kd}")
    return plan


def order_words(tbl: Table, keys: Sequence[str], plan, stats, masked: Sequence[bool],
                desc, nl) -> List[torch.Tensor]:
    """``build_order_words`` of ``tbl``'s keys under a global plan, over
    the table's capacity. A key masked elsewhere gets an all-valid mask
    here, so every shard's words have one layout; an empty table gives one
    padding row of zeros under a null mask (the reference's padding)."""
    from ..ops.sorting import build_order_words

    kcols = []
    for k, m in zip(keys, masked):
        c = tbl[k]
        if c.capacity == 0 or c.length == 0:
            c = Column(c.dtype, torch.zeros(max(c.capacity, 1), dtype=c.data.dtype,
                                            device=c.device),
                       torch.zeros(max(c.capacity, 1), dtype=torch.bool, device=c.device)
                       if m else None, 0, c.dictionary)
        elif m and c.validity is None:
            c = Column(c.dtype, c.data, c.bounds_mask(), c.length, c.dictionary)
        kcols.append(c)
    words, _ = build_order_words(
        kcols, [p[0] for p in plan], [p[1] for p in plan], [s.vmin for s in stats],
        [s.value_range for s in stats], [s.has_nan for s in stats],
        [s.has_null for s in stats], desc, nl, tbl.num_rows)
    return words


def shard_samples(w0: torch.Tensor, length: int, samples: int) -> torch.Tensor:
    """``samples`` quantiles of one shard's leading words (an empty shard
    repeats its padding word)."""
    sw = torch.sort(w0).values
    qpos = torch.arange(samples, device=w0.device) * max(length, 1) // samples
    return sw[qpos.clamp(0, w0.shape[0] - 1)]


def splitters_of(allsamp: torch.Tensor, n: int) -> torch.Tensor:
    """n - 1 splitters: word-space quantiles of every shard's samples."""
    allsamp = torch.sort(allsamp).values
    m = allsamp.shape[0]
    spos = (torch.arange(n - 1, device=allsamp.device) + 1) * m // n
    return allsamp[spos.clamp(0, m - 1)]


def dist_sort_values(st: ShardedTable, keys: Sequence[str], descending=False,
                     nulls_last=True, samples_per_shard: int = 128,
                     bucket: Optional[int] = None) -> ShardedTable:
    """Distributed sort: every row's order words from the global key stats
    (``ops.sorting.build_order_words``: multi-key, descending and null
    placement a key, NaN and null as ``sort_by_key`` orders them);
    ``samples_per_shard`` quantiles of each shard's leading word, gathered
    from every shard, give n - 1 splitters; a row goes to the shard
    ``searchsorted(splitters, w0, side="right")`` names, so rows whose
    leading words tie share a shard; each shard then sorts its rows by the
    words they brought. Shards hold ascending ranges in shard order, and
    ``concat_to_table()`` equals ``sort_by_key`` row for row."""
    from ..ops.copying import gather_table
    from ..ops.sortprim import multisort_perm

    mesh, n = st.mesh, st.n_shards
    keys = list(keys)
    desc = [descending] * len(keys) if isinstance(descending, bool) else list(descending)
    nl = [nulls_last] * len(keys) if isinstance(nulls_last, bool) else list(nulls_last)
    masked_all = set(_masked_names(st.tables, mesh))
    masked = [k in masked_all for k in keys]
    stats = [_global_key_stats(st, k) for k in keys]
    plan = sort_plan([st.dtypes[k] for k in keys], masked, stats)
    S = samples_per_shard
    with mesh.timed("local"):
        words = [order_words(t, keys, plan, stats, masked, desc, nl) for t in st.tables]
        samples = [shard_samples(w[0], t.num_rows, S) for w, t in zip(words, st.tables)]
    allsamp = mesh.comm.all_gather(mesh, samples)
    dev0 = samples[0].device
    splitters = splitters_of(torch.cat([s.to(dev0) for s in allsamp]), n)
    pids, extra = [], []
    for w, t in zip(words, st.tables):
        m = t.num_rows
        pids.append(torch.searchsorted(splitters.to(w[0].device), w[0][:m], right=True))
        extra.append({f"\0w{i}": wi[:m] for i, wi in enumerate(w)})
    received = _exchange(st, pids, extra)

    def local_sort(t: Table) -> Table:
        ws = [t[f"\0w{i}"].data[: t.num_rows] for i in range(len(words[0]))]
        return gather_table(t.select(st.names), multisort_perm(ws), t.num_rows)

    return _local(st, local_sort, received)


# ---------------------------------------------------------------------------
# elementwise stages and distinct
# ---------------------------------------------------------------------------

def dist_elementwise(st: ShardedTable, node) -> ShardedTable:
    """A Select, HStack, Filter or Projection IR node evaluated on each
    shard, on the shard's device, with the in-memory executor's semantics
    (an HStack's expressions see the columns added before them). Nothing
    is caught: an expression that fails raises."""
    from ..expr import ir as IRM
    from ..expr.expressions import evaluate
    from ..ops.stream_compaction import apply_boolean_mask

    def step(tbl: Table) -> Table:
        if isinstance(node, IRM.Filter):
            return apply_boolean_mask(tbl, evaluate(node.predicate, tbl))
        if isinstance(node, IRM.Select):
            return Table({ne.name: evaluate(ne.expr, tbl) for ne in node.exprs})
        if isinstance(node, IRM.HStack):
            for ne in node.exprs:
                tbl = tbl.with_column(ne.name, evaluate(ne.expr, tbl))
            return tbl
        if isinstance(node, IRM.Projection):
            return tbl.select(list(node.args[0]))
        raise TypeError(type(node).__name__)

    return _local(st, step)


# Distributed-fallback accounting, kept for the reference's interface
# (cudf-polars StreamingFallbackMode, python/cudf_polars/utils/config.py:111).
# No path of the port falls back, so the counts stay empty.
DIST_FALLBACK_COUNTS: Dict[str, int] = {}
_warned_fallbacks: set = set()


def note_dist_fallback(kind: str, exc: Exception) -> None:
    DIST_FALLBACK_COUNTS[kind] = DIST_FALLBACK_COUNTS.get(kind, 0) + 1
    if kind not in _warned_fallbacks:
        _warned_fallbacks.add(kind)
        import warnings

        warnings.warn(
            f"cudf_tpu_torch distributed: {kind} fell back to host evaluation "
            f"({type(exc).__name__}: {exc})", RuntimeWarning, stacklevel=3)


def reset_dist_fallbacks() -> None:
    DIST_FALLBACK_COUNTS.clear()
    _warned_fallbacks.clear()


def dist_distinct(st: ShardedTable, subset: Optional[Sequence[str]],
                  keep: str = "first") -> ShardedTable:
    """Distributed distinct: hash-shuffle on the key subset, then each
    shard's ``distinct`` (row order inside a shard kept). Every copy of a
    key is on one shard, so ``keep`` is any of ``distinct``'s."""
    from ..ops.stream_compaction import distinct

    keys = list(subset) if subset is not None else list(st.names)
    shuffled, _ = shuffle_by_key(st, keys)
    return _local(shuffled, lambda t: distinct(t, keys, keep))
