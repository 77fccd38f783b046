#!/usr/bin/env python3
"""Drive the cudf_tpu_torch port on one NVIDIA GPU and check what comes out.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits nonzero):

  1. build   — compile every CUDA kernel from csrc/ (nvcc, sm_90a), one nvcc
               process per source, all started together; then launch the
               launch-check kernel (o = 2x over f32[1024]) under a 120 s
               watchdog and hold it exactly against its plain version;
  2. kernels — call each kernel's wrapper on card tensors (the shapes the
               main path gives it, plus edge cases) against its plain PyTorch
               version; time kernel, plain version and library calls;
  3. main    — the README query at TPC-H SF10 lineitem size (60M rows):
               Table.from_pandas -> drop_nulls -> groupby_aggregate(
               [l_returnflag, l_linestatus], sum/mean/count/size of
               l_extendedprice) -> to_pandas, checked against pandas; launch
               counts are zeroed just before and read just after, and every
               kernel of the path must have launched;
  4. sort    — the code-sort lane on the same table: groupby l_orderkey
               (~15M groups) sum/mean/min/max/var, checked against pandas;
               the one-hot kernel must not launch;
  5. join    — TPC-H Q3's orders filter and lineitem join at SF10: orders
               (15M rows) -> binary_op(o_orderdate < 1995-03-15) ->
               apply_boolean_mask (~7.3M rows) -> join(lineitem[l_orderkey,
               l_extendedprice], filtered, inner, ordered=False) ->
               to_pandas, checked against a numpy searchsorted oracle as a
               multiset; then ordered=True row for row, semi and left (null
               where no match). Launch counts are zeroed just before and
               read just after; the probe kernel must have launched;
  6. join-general — filtered orders joined with lineitem as the build side
               (~4 rows a key): the general sort lane, checked against the
               oracle; the probe kernel must not launch;
  7. kernels — the probe kernel against its plain version on the main
               join's own table (slot views, no packing) and words and on
               edge cases (both table layouts, a chain that wraps); times.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Every time printed stands beside
the card's name and power limit. Exits nonzero, printing no result, when
CUDA is not available.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROWS = 60_000_000            # TPC-H SF10 lineitem
ORDERS = 15_000_000          # TPC-H SF10 orders
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published peak
F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores
WATCHDOG_S = 120             # benchmarks/pallas_tunnel_repro.py's watchdog
KEYS = ["l_returnflag", "l_linestatus"]
# TPC-H Q1's four (returnflag, linestatus) groups at SF10 and their shares:
# A-F, N-F, N-O, R-F (returnflag A=0 N=1 R=2, linestatus F=0 O=1)
Q1_GROUPS = np.array([[0, 0], [1, 0], [1, 1], [2, 0]], np.int32)
Q1_SHARES = np.array([0.2499, 0.0066, 0.4935, 0.2500])
# o_orderdate as int32 days since 1970-01-01: TPC-H's range 1992-01-01 ..
# 1998-08-02, and Q3's cut 1995-03-15
DAY_FIRST, DAY_LAST, Q3_DAY = 8035, 10440, 9204
JOIN_COLS = ["l_orderkey", "l_extendedprice", "o_orderkey", "o_orderdate",
             "o_shippriority"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms over ``iters`` launches, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, top: int = 6) -> str:
    """Device time of one fn() call by kernel, from torch.profiler (CUPTI):
    the ``top`` kernels, their share of the summed kernel time, and the
    summed kernel time over the host wall time of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern)
    if busy == 0:
        return "profiler saw no device time (not measured)"
    kern.sort(key=lambda e: -e.self_device_time_total)
    parts = [f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms "
             f"({100 * e.self_device_time_total / busy:.0f}%)" for e in kern[:top]]
    return (f"kernels {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
            f"(device busy {100 * busy / wall_us:.0f}%): " + "; ".join(parts))


def lineitem(n: int, seed: int):
    """pandas lineitem slice: Q1 keys with 2% null keys, f32 prices."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    g = rng.choice(len(Q1_SHARES), n, p=Q1_SHARES / Q1_SHARES.sum())
    keys = Q1_GROUPS[g]
    null_f = rng.random(n) < 0.01
    null_s = rng.random(n) < 0.01
    return pd.DataFrame({
        "l_returnflag": pd.arrays.IntegerArray(np.ascontiguousarray(keys[:, 0]), null_f),
        "l_linestatus": pd.arrays.IntegerArray(np.ascontiguousarray(keys[:, 1]), null_s),
        "l_extendedprice": rng.uniform(900.0, 105000.0, n).astype(np.float32),
        "l_orderkey": rng.integers(1, ORDERS + 1, n) * 4,
    })


def orders(n: int, seed: int):
    """pandas orders: o_orderkey = 4·(1..n), lineitem()'s key space;
    o_orderdate uniform int32 days; o_shippriority 0, as TPC-H has it."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "o_orderkey": 4 * np.arange(1, n + 1, dtype=np.int64),
        "o_orderdate": rng.integers(DAY_FIRST, DAY_LAST + 1, n).astype(np.int32),
        "o_shippriority": np.zeros(n, np.int32),
    })


# ---------------------------------------------------------------- phase 1
def build(gpu: str) -> None:
    import shutil

    from cudf_tpu_torch import kernels

    shutil.rmtree(kernels.BUILD, ignore_errors=True)  # build from the sources
    names = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    kernels.build_all(names)
    for name in names:
        kernels.load_library(name)
        log(f"build: {name} ok")
    log(f"build: [{gpu}] {len(names)} kernel(s) in {time.perf_counter() - t0:.2f} s "
        f"(host clock)")


def launch_check(gpu: str) -> dict:
    """The launch-and-return check: one launch on f32[1024] that must come
    back within WATCHDOG_S, exactly equal to its plain version."""
    import torch

    from cudf_tpu_torch.kernels import launch_check as lc

    returned = threading.Event()

    def watchdog():
        if not returned.wait(WATCHDOG_S):
            print(f"launch-check: the kernel launch did not return in {WATCHDOG_S} s",
                  file=sys.stderr, flush=True)
            os._exit(42)

    threading.Thread(target=watchdog, daemon=True).start()
    x = torch.arange(1024, dtype=torch.float32, device="cuda") - 511.5
    lc.double.launches = 0
    got = lc.double(x)
    torch.cuda.synchronize()
    returned.set()
    launches = lc.double.launches
    want = lc.double_plain(x)
    if launches != 1 or not torch.equal(got, want):
        raise AssertionError("launch-check kernel disagrees with its plain version")
    ms = cuda_ms(lambda: lc.double(x))
    plain_ms = cuda_ms(lambda: lc.double_plain(x))
    library_ms = cuda_ms(lambda: torch.mul(x, 2.0))
    nbytes = 8 * x.numel()
    bound_ms = max(nbytes / HBM_BYTES_PER_S, x.numel() / F32_FLOPS) * 1e3
    log(f"launch-check: [{gpu}] o = 2x over f32[1024] returned and equals its plain "
        f"version exactly; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mul "
        f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms")
    return {"name": "launch_check_double", "route": "cuda",
            "source": "cudf_tpu_torch/kernels/csrc/launch_check.cu",
            "replaces": "benchmarks/pallas_tunnel_repro.py:48",
            "note": "on no engine path: the counterpart of a launch-and-return repro",
            "launches": launches, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}


# ---------------------------------------------------------------- phase 2
def onehot_inputs(cap: int, n: int, seed: int, device):
    """The one-hot lane's kernel arguments at the main path's shape: the
    drop_nulls survivors' capacity bucket, K = 16 slots (2 + 2 key bits)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    edges = torch.tensor(np.cumsum(Q1_SHARES / Q1_SHARES.sum())[:-1], device=device)
    g = torch.bucketize(torch.rand(cap, device=device, generator=gen,
                                   dtype=torch.float64), edges)
    slot = torch.tensor([0, 4, 5, 8], device=device)[g].to(torch.int32)
    gid = torch.where(torch.arange(cap, device=device) < n, slot, -1).to(torch.int32)
    vals = torch.empty(cap, 1, device=device).uniform_(900.0, 105000.0, generator=gen)
    weight = (gid >= 0).to(torch.float32)
    return gid, vals, weight, 16


def _check_onehot(k, gid, vals, weight, K, is01: bool) -> float:
    """Kernel vs plain version on the same card tensors. The kernel sums in
    f32 inside a tile, in another order than the plain version's f64, so a
    sum may differ by rtol 1e-5 of the group's sum of |terms|; counts of 0/1
    weights are exact; a NaN stays in its group (both sides NaN there)."""
    import torch

    got = k.groupby_sum_count(gid, vals, weight, K)
    torch.cuda.synchronize()
    want = k.groupby_sum_count_plain(gid, vals, weight, K)
    scale = k.groupby_sum_count_plain(gid, vals.abs(), weight, K)
    V = vals.shape[1]
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"one-hot kernel: NaN in other groups than its plain "
                             f"version's, K={K} V={V}")
    got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
    err = (got - want).abs()
    bad = err[:, :V] > 1e-5 * scale[:, :V].nan_to_num(0.0) + 1e-6
    if is01:
        bad = torch.cat([bad, (got[:, V] != want[:, V])[:, None]], 1)
    else:
        bad = torch.cat([bad, (err[:, V:] > 1e-5 * scale[:, V:] + 1e-6)], 1)
    if bool(bad.any()):
        raise AssertionError(f"one-hot kernel disagrees with its plain version: "
                             f"K={K} V={V} max_abs_err={err.max().item()}")
    return err.max().item()


def kernels_vs_plain(gpu: str, cap: int, n_active: int) -> dict:
    import torch

    from cudf_tpu_torch.kernels import onehot_groupby as k

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    n = 1_000_003  # ragged: not a multiple of the kernel's tile
    for K in (1, 16, 37, 2048):
        for V in (1, 2):
            for weights in ("01", "zero", "real"):
                gid = torch.randint(-3, K + 3, (n,), device=dev, generator=gen,
                                    dtype=torch.int32)  # some out of [0, K)
                vals = torch.randn(n, V, device=dev, generator=gen)
                if weights == "01":
                    w = (torch.rand(n, device=dev, generator=gen) < 0.9).float()
                elif weights == "zero":
                    w = torch.zeros(n, device=dev)
                else:
                    w = torch.rand(n, device=dev, generator=gen) * 2.0
                max_err = max(max_err, _check_onehot(k, gid, vals, w, K,
                                                     weights != "real"))
    # the tiers' edges: K·(V+1) = 32 (registers), 33 and K = 2048 (shared
    # memory), on bases one row past 16 B alignment (the scalar head)
    for K, V in ((16, 1), (11, 2), (2048, 2)):
        gid = torch.randint(-3, K + 3, (n + 1,), device=dev, generator=gen,
                            dtype=torch.int32)[1:]
        vals = torch.randn(n + 1, V, device=dev, generator=gen)[1:]
        w = (torch.rand(n + 1, device=dev, generator=gen) < 0.9).float()[1:]
        max_err = max(max_err, _check_onehot(k, gid, vals, w, K, True))
    # a NaN in one group, in each tier: it stays there, the others stay finite
    for K in (16, 64):
        gid = torch.randint(0, 4, (n,), device=dev, generator=gen, dtype=torch.int32)
        vals = torch.randn(n, 1, device=dev, generator=gen)
        vals[int(torch.nonzero(gid == 2)[5]), 0] = float("nan")
        got = k.groupby_sum_count(gid, vals, torch.ones(n, device=dev), K)
        nan = got.isnan()
        if not (bool(nan[2, 0]) and int(nan.sum()) == 1):
            raise AssertionError(f"one-hot kernel: the NaN left its group (K={K})")
        max_err = max(max_err, _check_onehot(k, gid, vals, torch.ones(n, device=dev), K,
                                             True))
    gid, vals, w, K = onehot_inputs(cap, n_active, 2, dev)
    max_err = max(max_err, _check_onehot(k, gid, vals, w, K, True))
    first = k.groupby_sum_count(gid, vals, w, K)
    if not torch.equal(first, k.groupby_sum_count(gid, vals, w, K)):
        raise AssertionError("one-hot kernel: two launches on the main shape differ")
    log(f"kernels: onehot_groupby_sum_count matches its plain version on 30 cases "
        f"(K in 1/16/37/2048, V in 1/2, ragged N, 0/1, zero and real weights, "
        f"out-of-range gids; tier edges K(V+1) = 32/33 and K = 2048, V = 2 on "
        f"unaligned bases; a NaN in one group in both tiers), max_abs_err={max_err}; "
        f"two launches at the main shape give the same bits")

    # times at the main path's shape
    ms = cuda_ms(lambda: k.groupby_sum_count(gid, vals, w, K))
    plain_ms = cuda_ms(lambda: k.groupby_sum_count_plain(gid, vals, w, K))
    idx = torch.where(gid >= 0, gid.to(torch.int64), K)
    contrib = torch.cat([vals * w[:, None] * w[:, None], (w * w)[:, None]], 1).double()
    acc = torch.zeros(K + 1, 2, dtype=torch.float64, device=dev)
    index_add_ms = cuda_ms(lambda: acc.index_add_(0, idx, contrib))
    flat = (idx[:, None] * 2 + torch.arange(2, device=dev)).reshape(-1)
    bincount_ms = cuda_ms(lambda: torch.bincount(flat, contrib.reshape(-1),
                                                 minlength=(K + 1) * 2))
    library_ms = min(index_add_ms, bincount_ms)
    # The kernel reads every gid, but values and weight only of rows whose
    # gid lies in [0, K): the padding past n_active (gid -1) is never read.
    V = vals.shape[1]
    n_in = int(((gid >= 0) & (gid < K)).sum())
    nbytes = cap * 4 + n_in * (4 * V + 4) + K * (V + 1) * 8
    flops = n_in * (3 * V + 2)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    log(f"kernels: [{gpu}] onehot_groupby_sum_count N={cap} ({n_in} rows in range) "
        f"V={V} K={K}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, f64 index_add_ "
        f"{index_add_ms:.4f} ms, f64 bincount {bincount_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at 3.35 TB/s)")
    return {"name": "onehot_groupby_sum_count", "route": "cuda",
            "source": "cudf_tpu_torch/kernels/csrc/onehot_groupby.cu",
            "replaces": "cudf_tpu/kernels/onehot_groupby.py:30",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / F32_FLOPS else "operations", "library_ms": library_ms}


# ---------------------------------------------------------------- phase 3
def main_path(gpu: str, df):
    import torch

    from cudf_tpu_torch import AggSpec, Table, drop_nulls, groupby_aggregate
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as k

    aggs = [AggSpec("l_extendedprice", "sum", "sum_price"),
            AggSpec("l_extendedprice", "mean", "avg_price"),
            AggSpec("l_extendedprice", "count", "count_price"),
            AggSpec("", "size", "count_order")]
    q1 = df[KEYS + ["l_extendedprice"]]
    k.groupby_sum_count.launches = 0
    ht.probe_table.launches = 0
    t0 = time.perf_counter()
    tbl = Table.from_pandas(q1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kept = drop_nulls(tbl)
    out = groupby_aggregate(kept, KEYS, aggs).to_pandas()
    t2 = time.perf_counter()
    launches = k.groupby_sum_count.launches
    if launches < 1:
        raise AssertionError("main path did not launch the one-hot kernel")
    if ht.probe_table.launches:
        raise AssertionError("the groupby path launched the probe kernel")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    warm = groupby_aggregate(kept, KEYS, aggs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t3
    log(f"main: [{gpu}] {len(q1)} rows -> {kept.num_rows} after drop_nulls -> "
        f"{len(out)} groups; ingest {t1 - t0:.3f} s, drop_nulls+groupby+to_pandas "
        f"{t2 - t1:.3f} s (first), groupby warm {warm_s * 1e3:.2f} ms "
        f"(host clock); kernel launches {launches}")

    want = (q1.dropna().astype({"l_extendedprice": np.float64})
            .groupby(KEYS, sort=True)["l_extendedprice"]
            .agg(["sum", "mean", "count", "size"]).reset_index())
    np.testing.assert_array_equal(out[KEYS].to_numpy(np.int64),
                                  want[KEYS].to_numpy(np.int64))
    np.testing.assert_array_equal(out["count_price"].to_numpy(), want["count"].to_numpy())
    np.testing.assert_array_equal(out["count_order"].to_numpy(), want["size"].to_numpy())
    # f32 tile partial sums inside the kernel: rtol 1e-5
    np.testing.assert_allclose(out["sum_price"], want["sum"], rtol=1e-5)
    np.testing.assert_allclose(out["avg_price"], want["mean"], rtol=1e-5)
    if not np.isfinite(out[["sum_price", "avg_price"]].to_numpy()).all():
        raise AssertionError("non-finite aggregates")
    if warm.num_rows != len(out):
        raise AssertionError("warm run disagrees")
    log(f"main: matches pandas dropna().groupby(sort=True): {len(out)} groups, "
        f"keys and counts exact, sum/mean rtol 1e-5")
    log(f"main: [{gpu}] warm groupby profile: "
        + device_breakdown(lambda: groupby_aggregate(kept, KEYS, aggs)))
    return tbl, launches


# ---------------------------------------------------------------- phase 4
def sort_lane(gpu: str, tbl, df) -> None:
    import torch

    from cudf_tpu_torch import AggSpec, Column, Table, groupby_aggregate
    from cudf_tpu_torch.kernels import onehot_groupby as k

    kinds = ["sum", "mean", "min", "max", "var"]
    aggs = [AggSpec("l_extendedprice", kind, kind) for kind in kinds]
    t = Table({"l_orderkey": Column.from_numpy(df["l_orderkey"].to_numpy()),
               "l_extendedprice": tbl["l_extendedprice"]})
    before = k.groupby_sum_count.launches
    t0 = time.perf_counter()
    out = groupby_aggregate(t, ["l_orderkey"], aggs).to_pandas()
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    groupby_aggregate(t, ["l_orderkey"], aggs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    if k.groupby_sum_count.launches != before:
        raise AssertionError("the sort lane launched the one-hot kernel")
    log(f"sort: [{gpu}] {t.num_rows} rows -> {len(out)} groups; groupby+to_pandas "
        f"{first_s:.3f} s (first), groupby warm {warm_s * 1e3:.2f} ms (host clock)")

    p = df["l_extendedprice"].to_numpy().astype(np.float64)
    want = (df.assign(p=p).groupby("l_orderkey", sort=True)["p"]
            .agg(kinds + ["count"]).reset_index())
    np.testing.assert_array_equal(out["l_orderkey"].to_numpy(), want["l_orderkey"].to_numpy())
    np.testing.assert_array_equal(out["min"].to_numpy(np.float64), want["min"].to_numpy())
    np.testing.assert_array_equal(out["max"].to_numpy(np.float64), want["max"].to_numpy())
    # A group's sum is the difference of two f64 prefix sums over the whole
    # sorted table, so it carries an absolute error of a few ulps of the
    # running total, shared by every group (a one-row group of ~900 sees it
    # as ~1e-6 relative); 32 ulps covers a scan over 2^26 rows. The sum is
    # then rounded to f32 (2^-24 relative); mean is f64 sum / count.
    eps = np.finfo(np.float64).eps
    cnt = want["count"].to_numpy()
    atol_sum = 32 * eps * float(np.abs(p).sum())
    used = {}
    for name, atol, rtol in (("sum", atol_sum, 2.0 ** -23),
                             ("mean", atol_sum / cnt, 1e-12)):
        got_v, want_v = out[name].to_numpy(np.float64), want[name].to_numpy()
        err = np.abs(got_v - want_v)
        used[name] = float((err / (rtol * np.abs(want_v) + atol)).max())
        if used[name] > 1:
            raise AssertionError(f"{name} off by {err.max()} (beyond the prefix-sum bound)")
    # single-pass centred var: prefix sums of (x-K)^2 carry an absolute error
    # of a few ulps of the table-wide total, shared by every group
    xc = p - p.mean()
    atol_m2 = 1e3 * eps * float((xc * xc).sum())
    gv, wv = out["var"].to_numpy(), want["var"].to_numpy()
    if not np.array_equal(np.isnan(gv), np.isnan(wv)):
        raise AssertionError("var null pattern differs")
    ok = ~np.isnan(wv)
    err = np.abs(gv[ok] - wv[ok])
    tol = 1e-6 * np.abs(wv[ok]) + atol_m2 / np.maximum(cnt[ok] - 1, 1)
    if (err > tol).any():
        raise AssertionError(f"var off by {err.max()}")
    log(f"sort: matches pandas groupby(sort=True): {len(out)} groups, keys and "
        f"min/max exact, sum/mean/var within the prefix-sum bound (sum/mean "
        f"{atol_sum:.3g} absolute on the sum; worst error {used['sum']:.3f} of the "
        f"bound for sum, {used['mean']:.3f} for mean)")
    log(f"sort: [{gpu}] warm groupby profile: "
        + device_breakdown(lambda: groupby_aggregate(t, ["l_orderkey"], aggs)))


# ---------------------------------------------------------------- phase 5
def join_oracle(df, od):
    """The inner join's rows in lineitem order, by output column, and which
    lineitem rows match: numpy searchsorted over the sorted filtered order
    keys (queries taken in sorted order, which keeps the search in cache)."""
    keep = od["o_orderdate"].to_numpy() < Q3_DAY
    f = {c: od[c].to_numpy()[keep] for c in od.columns}
    lk = df["l_orderkey"].to_numpy()
    order = np.argsort(lk)
    idx = np.empty(len(lk), np.int64)
    idx[order] = np.searchsorted(f["o_orderkey"], lk[order])
    idx = np.minimum(idx, len(f["o_orderkey"]) - 1)
    match = f["o_orderkey"][idx] == lk
    want = {"l_orderkey": lk[match],
            "l_extendedprice": df["l_extendedprice"].to_numpy()[match]}
    for c in ("o_orderkey", "o_orderdate", "o_shippriority"):
        want[c] = f[c][idx[match]]
    return want, match


def assert_rows(got: dict, want: dict, what: str, as_multiset: bool) -> None:
    """Every column exactly equal, row for row or after one sort of both
    sides by (l_orderkey, l_extendedprice bits): rows equal on those two
    are equal on every column, since the orders columns follow the key."""
    n = len(want["l_orderkey"])
    if len(got["l_orderkey"]) != n:
        raise AssertionError(f"{what}: {len(got['l_orderkey'])} rows, oracle {n}")
    if as_multiset:
        def order(d):
            return np.argsort((d["l_orderkey"].astype(np.int64) << 32)
                              | d["l_extendedprice"].view(np.uint32))
        go, wo = order(got), order(want)
        got = {c: v[go] for c, v in got.items()}
        want = {c: v[wo] for c, v in want.items()}
    for c in want:
        if not np.array_equal(got[c], want[c]):
            raise AssertionError(f"{what}: column {c} differs from the oracle")


def _columns(tbl, names) -> dict:
    return {c: tbl[c].data[: tbl.num_rows].cpu().numpy() for c in names}


def join_path(gpu: str, df, od, want, match):
    import torch

    from cudf_tpu_torch import Column, Table, apply_boolean_mask, binary_op, join
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as oh

    li = Table({"l_orderkey": Column.from_numpy(df["l_orderkey"].to_numpy()),
                "l_extendedprice": Column.from_numpy(df["l_extendedprice"].to_numpy())})
    torch.cuda.synchronize()

    def q3(ot):
        filtered = apply_boolean_mask(ot, binary_op(ot["o_orderdate"], Q3_DAY, "lt"))
        return filtered, join(li, filtered, ["l_orderkey"], ["o_orderkey"], "inner",
                              ordered=False)

    ht.probe_table.launches = 0
    ht.probe_table.packs = 0
    oh.groupby_sum_count.launches = 0
    t0 = time.perf_counter()
    ot = Table.from_pandas(od)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    filtered, out = q3(ot)
    got = out.to_pandas()
    t2 = time.perf_counter()
    launches = ht.probe_table.launches
    if launches < 1:
        raise AssertionError("the join path did not launch the probe kernel")
    if oh.groupby_sum_count.launches:
        raise AssertionError("the join path launched the one-hot kernel")
    if ht.probe_table.packs:
        raise AssertionError("the join path packed its table: not build_table's slots")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    q3(ot)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t3
    log(f"join: [{gpu}] {ORDERS} orders -> {filtered.num_rows} after o_orderdate < "
        f"1995-03-15; {li.num_rows} lineitem rows -> {len(got)} joined rows; orders "
        f"ingest {t1 - t0:.3f} s, filter+join+to_pandas {t2 - t1:.3f} s (first), "
        f"filter+join warm {warm_s * 1e3:.2f} ms (host clock); probe launches {launches}")

    assert_rows({c: got[c].to_numpy() for c in JOIN_COLS}, want, "inner unordered", True)
    ordered = join(li, filtered, ["l_orderkey"], ["o_orderkey"], "inner")
    assert_rows(_columns(ordered, JOIN_COLS), want, "inner ordered", False)
    semi = join(li, filtered, ["l_orderkey"], ["o_orderkey"], "semi")
    assert_rows(_columns(semi, ["l_orderkey", "l_extendedprice"]),
                {c: want[c] for c in ("l_orderkey", "l_extendedprice")}, "semi", False)
    left = join(li, filtered, ["l_orderkey"], ["o_orderkey"], "left")
    if left.num_rows != li.num_rows:
        raise AssertionError(f"left: {left.num_rows} rows, want {li.num_rows}")
    for c in ("o_orderkey", "o_orderdate", "o_shippriority"):
        col = left[c]
        valid = col.validity[: li.num_rows].cpu().numpy()
        if not np.array_equal(valid, match):
            raise AssertionError(f"left: nulls of {c} differ from the unmatched rows")
        if not np.array_equal(col.data[: li.num_rows].cpu().numpy()[match], want[c]):
            raise AssertionError(f"left: column {c} differs from the oracle")
    log(f"join: matches the numpy oracle: inner (ordered=False as a multiset, "
        f"ordered=True row for row), semi and left (null where no match), every "
        f"column exact; {int(match.sum())} of {len(match)} lineitem rows match")
    log(f"join: [{gpu}] warm filter+join profile: " + device_breakdown(lambda: q3(ot)))
    return li, filtered, launches


# ---------------------------------------------------------------- phase 6
def join_general(gpu: str, li, filtered, want) -> None:
    import torch

    from cudf_tpu_torch import join
    from cudf_tpu_torch.kernels import hashtable as ht

    before = ht.probe_table.launches

    def run():
        return join(filtered, li, ["o_orderkey"], ["l_orderkey"], "inner",
                    ordered=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run().to_pandas()
    first_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    if ht.probe_table.launches != before:
        raise AssertionError("the general lane launched the probe kernel")
    assert_rows({c: got[c].to_numpy() for c in JOIN_COLS}, want, "general inner", True)
    log(f"join-general: [{gpu}] {filtered.num_rows} filtered orders x {li.num_rows} "
        f"lineitem (build side, ~4 rows a key) -> {len(got)} rows, matches the "
        f"oracle as a multiset; join+to_pandas {first_s:.3f} s (first), join warm "
        f"{warm_s * 1e3:.2f} ms (host clock)")
    log(f"join-general: [{gpu}] warm join profile: " + device_breakdown(run))


# ---------------------------------------------------------------- phase 7
def _u32(a, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev)


def probe_edge_cases(ht, dev) -> int:
    """Probe kernel vs plain version, exactly, on small tables the port's
    build_table makes on the card (slot views: m = 16; a ragged N of
    2·8192 + 77; a table at 61% load with unplaced rows) and on hand-built
    probe chains as three separate arrays, which the wrapper packs: a match
    at probe 15, a key absent after 16 occupied slots, a vacant slot before
    a would-be match, a chain that wraps from slot m-1 to 0."""
    import torch

    rng = np.random.default_rng(7)
    cases = []
    for n, m, nq in ((6, 16, 12), (2000, 16384, 2 * 8192 + 77), (20000, 32768, 20000)):
        base = rng.choice(2**31, n, replace=False)
        k1, k2 = _u32(base & 0xFFFF, dev), _u32(base >> 16, dev)
        table = ht.build_table(k1, k2, torch.ones(n, dtype=torch.bool, device=dev), m)[:3]
        pick = torch.from_numpy(rng.integers(0, n, nq)).to(dev)
        flip = torch.from_numpy((rng.random(nq) < 0.2).astype(np.int32)).to(dev)
        cases.append((table, k1[pick] ^ flip, k2[pick], None))
    q1 = np.uint32(0xDEADBEEF)
    cand = np.arange(12345, 12345 + 4096, dtype=np.uint32)
    homes = ht._mix(_u32(np.full(len(cand), q1), "cpu"), _u32(cand, "cpu")).numpy() & 63
    wrap_q2 = cand[np.flatnonzero(homes == 61)[0]]  # home slot m - 3
    for kind, fill, at, want in (("match_at_15", 15, 15, 7), ("absent_after_16", 16, 16, None),
                                 ("vacant_before", 3, 4, None), ("wraps", 5, 5, 7)):
        q2 = wrap_q2 if kind == "wraps" else np.uint32(12345)
        h = int(ht._mix(_u32([q1], "cpu"), _u32([q2], "cpu"))[0])
        tk1, tk2 = np.zeros(64, np.uint32), np.zeros(64, np.uint32)
        pay = np.full(64, ht.EMPTY, np.int32)
        for i in range(fill):
            s = (h + i) & 63
            tk1[s], tk2[s], pay[s] = (q1 if kind in ("match_at_15", "wraps") else i), i + 1, 100 + i
        s = (h + at) & 63
        tk1[s], tk2[s], pay[s] = q1, q2, 7
        table = (_u32(tk1, dev), _u32(tk2, dev), torch.from_numpy(pay).to(dev))
        cases.append((table, _u32([q1, 99], dev), _u32([q2, 98], dev),
                      ht.EMPTY if want is None else want))
    for table, a, b, want in cases:
        packs = ht.probe_table.packs
        got = ht.probe_table(*table, a, b)
        torch.cuda.synchronize()
        if ht.probe_table.packs - packs != (table[0].stride() == (1,)):
            raise AssertionError("probe wrapper: slot views packed, or arrays not packed")
        if not torch.equal(got, ht.probe_table_plain(*table, a, b)):
            raise AssertionError("probe kernel disagrees with its plain version")
        if want is not None and got[0].item() != want:
            raise AssertionError(f"probe chain case: got {got[0].item()}, want {want}")
    return len(cases)


def probe_vs_plain(gpu: str, li, filtered) -> dict:
    import torch

    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.ops import fastjoin

    dev = torch.device("cuda")
    n_edge = probe_edge_cases(ht, dev)
    built = fastjoin.build_hash_table([li["l_orderkey"]], [filtered["o_orderkey"]], False)
    if built is None:
        raise AssertionError("the main join's keys built no hash table")
    (q1, q2), table, n_build = built
    if ht.slot_tensor(*table) is None:
        raise AssertionError("the main join's table is not in the slot layout")
    packs = ht.probe_table.packs
    got = ht.probe_table(*table, q1, q2)
    torch.cuda.synchronize()
    if ht.probe_table.packs != packs:
        raise AssertionError("the main join's table was packed before the probe")
    want = ht.probe_table_plain(*table, q1, q2)
    max_err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    if max_err != 0:
        raise AssertionError("probe kernel disagrees with its plain version at the "
                             "main join's shape")
    log(f"kernels: hashtable_probe equals its plain version exactly on {n_edge} edge "
        f"cases (both layouts, a chain that wraps) and on the main join's table "
        f"(slot views, reached the kernel with no packing) and words")

    ms = cuda_ms(lambda: ht.probe_table(*table, q1, q2))
    plain_ms = cuda_ms(lambda: ht.probe_table_plain(*table, q1, q2), iters=5)

    def packed(w1, w2):
        return (w2.to(torch.int64) << 32) | (w1.to(torch.int64) & 0xFFFFFFFF)

    occ = table[2] != ht.EMPTY
    build_keys = torch.sort(packed(table[0][occ], table[1][occ])).values
    probe_keys = packed(q1, q2)
    library_ms = cuda_ms(lambda: torch.searchsorted(build_keys, probe_keys))
    m, n = table[0].shape[0], q1.shape[0]
    nbytes = 12 * m + 12 * n  # table once, two query words and the result
    ops = 12 * n              # hash and one probe's compares, 32-bit ALU ops
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    log(f"kernels: [{gpu}] hashtable_probe N={n} queries, m={m} slots for {n_build} "
        f"build rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, searchsorted "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
        f"3.35 TB/s)")
    return {"name": "hashtable_probe", "route": "cuda",
            "source": "cudf_tpu_torch/kernels/csrc/hashtable_probe.cu",
            "replaces": "cudf_tpu/kernels/hashtable.py:83",
            "launches": 0, "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / F32_FLOPS else "operations", "library_ms": library_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import cudf_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    gpu = card()
    t_start = time.perf_counter()
    build(gpu)
    check = launch_check(gpu)
    t0 = time.perf_counter()
    df = lineitem(ROWS, seed=0)
    log(f"data: [{gpu}] {ROWS} lineitem rows generated in "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    n_active = int(df[KEYS].notna().all(axis=1).sum())
    from cudf_tpu_torch.utils.padding import bucket_capacity

    onehot = kernels_vs_plain(gpu, bucket_capacity(n_active), n_active)
    tbl, onehot["launches"] = main_path(gpu, df)
    sort_lane(gpu, tbl, df)
    del tbl
    t0 = time.perf_counter()
    od = orders(ORDERS, seed=1)
    want, match = join_oracle(df, od)
    log(f"data: [{gpu}] {ORDERS} orders and the numpy join oracle in "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    t0 = time.perf_counter()
    li, filtered, probe_launches = join_path(gpu, df, od, want, match)
    t1 = time.perf_counter()
    join_general(gpu, li, filtered, want)
    t2 = time.perf_counter()
    probe = probe_vs_plain(gpu, li, filtered)
    log(f"phases: [{gpu}] join {t1 - t0:.1f} s, join-general {t2 - t1:.1f} s, probe "
        f"kernel checks {time.perf_counter() - t2:.1f} s (host clock, checks included)")
    probe["launches"] = probe_launches
    log(f"total: [{gpu}] {time.perf_counter() - t_start:.1f} s (host clock)")
    log(gpu)
    log(json.dumps({"kernels": [onehot, probe, check]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
