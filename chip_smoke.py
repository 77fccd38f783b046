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
               version; time kernel, plain version and library calls; the
               segment reduction at the h2o q6 shape (2^27 sorted rows,
               10,001 segments, f64), then the db-benchmark's q6 and q7
               through the DataFrame at 4M rows against pandas, with the
               reduction's launches counted in each; the dense-slot
               groupby kernel against its plain version at TPC-H Q1's
               shape at SF30 (177M rows, 8 slots, five f64 sums) and the
               db-benchmark q4's (1e8 rows, 128 slots, two int32 and one
               f64 column), then Q1's groupby through groupby_aggregate by
               the dense lane and by the sort lane, in turns;
  3. main    — the README query at TPC-H SF10 lineitem size (60M rows):
               Table.from_pandas -> drop_nulls -> groupby_aggregate(
               [l_returnflag, l_linestatus], sum/mean/count/size of
               l_extendedprice) -> to_pandas, checked against pandas; launch
               counts are zeroed just before and read just after, and every
               kernel of the path must have launched;
  4. sort    — the code-sort lane on the first 16M rows (CUT_ROWS) of the
               same table: groupby l_orderkey sum/mean/min/max/var, checked
               against pandas; the one-hot kernel must not launch. Then
               argmin and argmax of l_extendedprice at (a) those 16M rows by
               l_orderkey and (b) phase 3's 60M rows by [l_returnflag,
               l_linestatus]: sortgroup.sort_groupby, widegroup.wide_groupby
               and groupby.generic_groupby called
               directly on the same input, each answer exact against pandas'
               idxmin/idxmax and the lanes bit for bit against each other;
               their warm times in turns (best of ARG_RUNS), the lane that
               groupby_aggregate takes and the fastest lane's device profile;
               the segment reduction's launch count is zeroed before (a) and
               read after (b), and must be one or more;
  5. join    — TPC-H Q3's orders filter and lineitem join at SF10: orders
               (15M rows) -> binary_op(o_orderdate < 1995-03-15) ->
               apply_boolean_mask (~7.3M rows) -> join(lineitem[l_orderkey,
               l_extendedprice], filtered, inner, ordered=False) ->
               to_pandas, checked against a numpy searchsorted oracle as a
               multiset; then ordered=True row for row, semi and left (null
               where no match). Launch counts are zeroed just before and
               read just after the first run; the probe kernel and the
               insert kernel (one a hash build) must have launched;
  6. join-general — filtered orders joined with the first 16M lineitem rows
               (CUT_ROWS) as the build side (~1 row a key), ordered=True
               (with ordered=False the swap would build on the filtered
               orders): the general sort lane, checked against the oracle;
               the probe kernel must not launch;
  7. kernels — the probe kernel against its plain version on the main
               join's own table (slot views, no packing) and words and on
               edge cases (both table layouts, a chain that wraps); times;
               its bound from the distinct 32 B sectors along the main
               join's probe chains, beside S, the slot reads (probe_reads
               walks each query's chain as the plain version does). Then
               the hash build (insert_vs_plain): the insert kernel against
               its plain version at TPC-H SF30 Q21's largest build (38.6M
               distinct order keys, 2^27 slots) and q5's customers (keys
               0..4,499,999, 2^24 slots), every key found with the
               build's own probe bound; the kernel's time beside its bound
               (16 B a slot filled, 9 B read and a 32 B sector read and
               written a row), the plain version's, and the capped rounds'
               build at two sizes that the kernel replaced;
  8. sort    — bench.py's sort shape at 60M rows: sort_by_key([k1 f64 with
               2% NaN, k2 f32]) carrying v, against a stable numpy lexsort,
               every column exact; first and warm times, device profile;
  9. tpch    — TPC-H q1, q3, q5 and q6 (benchmarks/tpch.py's plans, copied
               here) through cudf_tpu_torch.expr.ir.execute at SF10
               (gen_tables(60M): lineitem 60M, orders 15M, customer 1.5M,
               supplier 150K rows), each against a pandas oracle
               (assert_frame_equal rtol 1e-6); first and warm times, the
               per-node profile of execute_with_profile and the device
               profile; launch counts are zeroed before the queries and read
               after, and q3 and q5 must launch the probe kernel (and one
               insert a hash build: its launches and past_max_probe, the
               builds the capped rounds would have redone, are printed for
               each query). Then the
               datetime checks on l_shipdate (60M rows): extract of year,
               month, day, weekday, day_of_year and microsecond and truncate
               to M and Y against pandas .dt exactly (weekday ISO, pandas + 1),
               and one IR plan summing l_extendedprice by .dt.year() against
               pandas (rtol 1e-6);
 10. strings — bench.py's high-cardinality keys (regex_hc, tokens_hc) at 16M
               rows from a pool of 8M "url/{i:09x}/page" values: contains with
               bench.py's regex and a selective one, startswith, count_tokens,
               len_strings and extract_re, each row exactly equal to an oracle
               computed on the pool with Python re or numpy; the regexes, the
               extract and count_tokens must take their device lanes (their
               launch counters); first and warm times, device profile;
 11. io      — parquet files written by pyarrow to a temporary directory:
               bench.py's scan_parquet shape (60M rows of k int64, v f32, w
               f32): read_parquet(path)["v"] and a device sum, v exact, k and w
               never decoded; TPC-H q3 with its tables read through
               IR.Scan("parquet") equal to phase 9's in-memory q3 exactly, with
               the probe kernel launched twice (counts zeroed just before);
               q3's result through IR.Sink("parquet") and read back equal.
 12. frame   — the DataFrame API, beside the phases whose data it reuses:
               after phase 3, the README quick start ctt.from_pandas(...)
               .dropna().groupby(keys).agg(mean, sum, size) at 60M rows
               against pandas, with the one-hot kernel's launches counted
               (its V = 2 time at that shape), and Series shift, diff,
               rolling(7).mean(), hash_values and a categorical round trip;
               after phase 5, DataFrame.merge on the hash lane (probe
               launches counted) and sort_values against the oracle; in
               phase 11, ctt.read_parquet(p)["v"].sum() decoding only v and
               ctt.read_parquet(p).dropna().groupby("k").agg(mean) with 3M
               groups against numpy.
 13. out-of-core — beside the phases whose data it reuses, under budgets
               (utils.hbm.HbmBudget) below the data they govern: after phase
               4, phase 3's columns written to parquet in 1M-row row groups
               and read through PartitionedFrame.read_parquet_chunked under a
               budget of a quarter of their bytes with the native
               PartitionStore installed, the README query run on the spilled
               partitions (map_partitions(drop_nulls), groupby_agg) equal to
               phase 3's answer, with spills, one-hot launches for every
               partition and a peak allocation below the columns' bytes; and
               drop_nulls of phase 3's table on its chunked branch; after
               phase 5, join_small of 16 spilled lineitem partitions with
               the filtered orders, equal to the oracle, one probe launch a
               partition; after phase 8, PartitionedFrame.sort_values of the
               60M-row sort table in 32 spilled partitions, ascending and
               descending, and sort_by_key on its chunked branch, each equal
               to the in-memory sort exactly; inside phase 9, q1's groupby on
               its chunked branch and q1, q3, q5 and q6 through
               execute_partitioned (lineitem in 4 partitions, broadcast and
               shuffle joins), each equal to IR.execute's answer.
 14. nested and long tail — beside the phases whose data it reuses:
               after phase 3, cut(l_extendedprice, 16) and qcut(..., 10) at
               60M rows equal to pandas.cut/qcut and groupby(bin).agg(mean,
               size) through the Table API and the frame on the one-hot
               kernel; t-digest of the 60M prices (and the merge of 4
               partition digests) within 0.01 in rank of the sorted column;
               approx_distinct_count(l_orderkey) within 5%; pack of phase
               3's table, unpacked and split into 8 exactly; md5, sha256 and
               xxhash_64 of [l_orderkey, l_extendedprice] at 16M rows, all
               eight algorithms on 1M rows against hashlib and the CPU path
               on a 200,000-row sample, hash_values for every method; after
               phase 4, groupby_collect(l_orderkey) of 16M rows against
               groupby(sort=True).agg(list) and list_sort; after phase 5, a
               bloom filter over the filtered o_orderkey probed with the
               60M l_orderkey (no false negatives, false positives within
               twice the analytic share); in phase 9, mixed_join of
               lineitem with Q3's filtered orders and l_shipdate >
               o_orderdate + 60 days for inner, left, semi and anti on the
               probe kernel against numpy, conditional_join of the first
               1M lineitem rows with 1,000 price bands (inner, left,
               IR.ConditionalJoin) against searchsorted; after phase 10,
               split_record of the 16M strings, extract, list_contains,
               list_unique, list_sort and explode + groupby(token) against
               the pool's split, then Series.str.split(expand=False) ->
               DataFrame.explode -> merge with the pool's 8M middle tokens
               on the probe kernel; in phase 11, phase 11's scan file read
               as s3://bench/scan.parquet from a local http.server on
               127.0.0.1 (every request SigV4-signed) equal to the local
               read, and 1M rows written to avro with the null codec and read
               back through io.scan, and with deflate through IR.Scan, exactly.
 15. accelerator and decimals — beside the phases whose data it reuses:
               cudf_tpu_torch.prewarm(60M) in a thread while phase 3's rows
               are generated; after phase 3, l_extendedprice from_floats at
               scale -2 and a seeded l_discount 0..10 at -2, price * (1 -
               disc) at -4 with its sum, round, rescale and compare exact
               against numpy int64, groupby(l_discount) on the one-hot
               kernel, and decimal128 on 16M rows (mul, a square past 2^64,
               rescale, compare, the sort by order_operands; division of 1M
               rows on the host against Python's decimal); after phase 12's
               quick start, the same quick start as pandas code through
               pandas_accel.install() (one-hot launches, no fallback, equal
               to the frame's answer exactly); after phase 5, P.merge of the
               filtered orders with lineitem (one probe launch, no
               fallback) and the join on decimal64 keys (probe launches);
               in phase 11, python -m cudf_tpu_torch.pandas on a script
               holding the quick start; the quick start once under
               utils.tracing.profiler_trace (its groupby_aggregate range
               in the trace); the first sort_by_key of 16M keys in a
               fresh process with and without prewarm; last, benchmarks/pandas_compat.py's
               49 cases through the accelerator (pass rate 1.00), and
               neither jax nor cudf_tpu in sys.modules.
 16. distributed — parallel/spmd.py over make_mesh(8): 8 shards, the
               reference's 8-device count, round-robin over the visible
               cards (all on cuda:0 on one H100). Beside the phases whose
               data it reuses: after phase 3, dist_groupby of the README
               query over the 60M rows (null keys form groups; the groups
               with both keys equal phase 3's answer; one one-hot launch
               for each shard that holds rows, none for an empty one); after
               phase 5, the Q3
               dist_join of the sharded 60M lineitem rows and filtered
               orders (equal to the oracle as a multiset; a probe launch a
               shard); after phase 8, dist_sort_values on [k1, k2
               descending] (equal to sort_by_key row for row); in phase 9,
               broadcast_join of the sharded SF10 lineitem with supplier on
               l_suppkey and with a 3-row table on the string
               l_returnflag (equal to the in-memory join row for row),
               execute_spmd of q1/q3/q5/q6 (equal to IR.execute) and
               execute_streaming of q1 in target_partition_rows chunks;
               after phase 11, two worker processes sharing the card
               (TCPStore on a free port, MP_TIMEOUT_S each), each running
               execute_multiproc of q1 and q3 at SF1 against IR.execute and
               a host_exchange of lineitem halves; dist_groupby across 2
               ranks under NCCL only with two or more cards. Each op prints
               shards, rows a shard, bytes exchanged, exchange against
               shard-local time, launches and DIST_FALLBACK_COUNTS (empty).
 17. wide    — the wide-key groupby lane (ops/widegroup.py), inside phase
               9 beside its SF10 tables: (a) 60M rows of bench.py's sparse
               62-bit surrogate ids, k1 from n // 20 distinct and k2 from a
               pool of 16 with 1% nulls, grouped by [k1, k2] with mean,
               sum, count, var, min, max, first, last and size of a seeded
               f64, dropna_keys True and False; (b) lineitem grouped by
               l_extendedprice (f64, not integral) with sum(l_quantity),
               mean(l_discount) and size. Each through groupby_aggregate
               against pandas (keys, order and counts exact, floats rtol
               1e-6); the wide lane's counter (wide_groupby.launches) must
               show that it answered, and neither kernel may launch; then
               the warm times of the wide lane and the generic engine
               (groupby.generic_groupby) on the same input, in turns, and
               each one's device breakdown.

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
import tempfile
import threading
import time

import numpy as np
import pandas as pd

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
# The code-sort groupby (phase 4) and the general join lane (phase 6) run on
# the first CUT_ROWS lineitem rows, to keep the script near 7 minutes.
CUT_ROWS = 16_000_000


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


def host_us(fn, iters: int = 2000) -> float:
    """Mean host time of fn() in microseconds, the device left to run
    behind it (what a launch costs the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def ctypes_us(iters: int = 20000) -> float:
    """Mean time of one ctypes call into a kernel library, on an entry point
    that launches nothing (the one-hot kernel's grid size)."""
    import ctypes

    from cudf_tpu_torch.kernels import entry

    fn, blocks = entry("onehot_groupby", "onehot_groupby_blocks"), ctypes.c_int(0)
    ref = ctypes.byref(blocks)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(1024, 1, 16, 0, ref)
    return (time.perf_counter() - t0) / iters * 1e6


# the ranges that cudf_tpu_torch.utils.tracing.trace_op opens
TRACED = {"groupby_aggregate", "join", "sort_by_key", "DataFrame.merge"}


def device_breakdown(fn, top: int = 6) -> str:
    """Device time of one fn() call by kernel, from torch.profiler (CUPTI):
    the ``top`` kernels, their share of the summed kernel time, and the
    summed kernel time over the host wall time of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    span = f"; CUDA-event span of the call {start.elapsed_time(end):.3f} ms"
    # a range of utils/tracing.py spans its kernels on the device too: not a kernel
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and e.key not in TRACED]
    busy = sum(e.self_device_time_total for e in kern)
    if busy == 0:
        return "profiler saw no device time (not measured)" + span
    kern.sort(key=lambda e: -e.self_device_time_total)
    parts = [f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms "
             f"({100 * e.self_device_time_total / busy:.0f}%)" for e in kern[:top]]
    return (f"kernels {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
            f"(device busy {100 * busy / wall_us:.0f}%{span}): " + "; ".join(parts))


def lineitem(n: int, seed: int):
    """pandas lineitem slice: Q1 keys with 2% null keys, f32 prices."""
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
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "o_orderkey": 4 * np.arange(1, n + 1, dtype=np.int64),
        "o_orderdate": rng.integers(DAY_FIRST, DAY_LAST + 1, n).astype(np.int32),
        "o_shippriority": np.zeros(n, np.int32),
    })


# ------------------------------------------------ TPC-H tables and plans
# benchmarks/tpch.py's generator and plan builders, copied as they are (this
# script imports nothing of benchmarks/); tests/test_torch_tpch.py holds the
# copies equal to the originals.
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]


def gen_tables(n_lineitem: int, seed=0):
    """dbgen-lite: lineitem/orders/customer/supplier/nation/region."""
    rng = np.random.default_rng(seed)
    n_orders = max(n_lineitem // 4, 10)
    n_cust = max(n_orders // 10, 10)
    n_supp = max(n_lineitem // 400, 5)
    n_nation = 25

    def dates(n, lo="1992-01-01", days=2556):
        return pd.Timestamp(lo) + pd.to_timedelta(rng.integers(0, days, n), unit="D")

    lineitem = pd.DataFrame({
        "l_orderkey": rng.integers(0, n_orders, n_lineitem),
        "l_suppkey": rng.integers(0, n_supp, n_lineitem),
        "l_quantity": rng.integers(1, 51, n_lineitem).astype(np.float64),
        "l_extendedprice": rng.uniform(900, 105000, n_lineitem).round(2),
        "l_discount": rng.integers(0, 11, n_lineitem) / 100.0,
        "l_tax": rng.integers(0, 9, n_lineitem) / 100.0,
        "l_returnflag": rng.choice(["A", "N", "R"], n_lineitem),
        "l_linestatus": rng.choice(["O", "F"], n_lineitem),
        "l_shipdate": dates(n_lineitem),
    })
    orders = pd.DataFrame({
        "o_orderkey": np.arange(n_orders),
        "o_custkey": rng.integers(0, n_cust, n_orders),
        "o_orderdate": dates(n_orders),
        "o_shippriority": np.zeros(n_orders, np.int64),
    })
    customer = pd.DataFrame({
        "c_custkey": np.arange(n_cust),
        "c_mktsegment": rng.choice(SEGMENTS, n_cust),
        "c_nationkey": rng.integers(0, n_nation, n_cust),
    })
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(n_supp),
        "s_nationkey": rng.integers(0, n_nation, n_supp),
    })
    nation = pd.DataFrame({
        "n_nationkey": np.arange(n_nation),
        "n_name": [f"NATION_{i:02d}" for i in range(n_nation)],
        "n_regionkey": rng.integers(0, 5, n_nation),
    })
    region = pd.DataFrame({
        "r_regionkey": np.arange(5),
        "r_name": REGIONS,
    })
    return dict(lineitem=lineitem, orders=orders, customer=customer,
                supplier=supplier, nation=nation, region=region)


def build_q1(T, E, IR, col):
    cutoff = np.datetime64("1998-09-02")
    return IR.Sort(("l_returnflag", "l_linestatus"), (False, False), (True, True), children=(
        IR.GroupBy(
            ("l_returnflag", "l_linestatus"),
            (E.NamedExpr("sum_qty", col("l_quantity").sum()),
             E.NamedExpr("sum_base_price", col("l_extendedprice").sum()),
             E.NamedExpr("sum_disc_price", (col("l_extendedprice") * (1 - col("l_discount"))).sum()),
             E.NamedExpr("sum_charge", (col("l_extendedprice") * (1 - col("l_discount")) * (1 + col("l_tax"))).sum()),
             E.NamedExpr("avg_qty", col("l_quantity").mean()),
             E.NamedExpr("avg_price", col("l_extendedprice").mean()),
             E.NamedExpr("avg_disc", col("l_discount").mean()),
             E.NamedExpr("count_order", E.Len())),
            children=(IR.Filter(col("l_shipdate") <= E.Literal(cutoff),
                                children=(T("lineitem"),)),),
        ),))


def build_q3(T, E, IR, col):
    cutoff = np.datetime64("1995-03-15")
    return IR.Slice(0, 10, children=(
        IR.Sort(("revenue",), (True,), (True,), children=(
            IR.GroupBy(
                ("o_orderkey", "o_shippriority"),
                (E.NamedExpr("revenue", (col("l_extendedprice") * (1 - col("l_discount"))).sum()),),
                children=(
                    IR.Join(("o_orderkey",), ("l_orderkey",), "inner", children=(
                        IR.Join(("c_custkey",), ("o_custkey",), "inner", children=(
                            IR.Filter(col("c_mktsegment") == E.lit("BUILDING"),
                                      children=(T("customer"),)),
                            IR.Filter(col("o_orderdate") < E.Literal(cutoff),
                                      children=(T("orders"),)),
                        )),
                        IR.Filter(col("l_shipdate") > E.Literal(cutoff),
                                  children=(T("lineitem"),)),
                    )),
                ),),
        )),))


def build_q5(T, E, IR, col):
    lo = np.datetime64("1994-01-01")
    hi = np.datetime64("1995-01-01")
    return IR.Sort(("revenue",), (True,), (True,), children=(
        IR.GroupBy(
            ("n_name",),
            (E.NamedExpr("revenue", (col("l_extendedprice") * (1 - col("l_discount"))).sum()),),
            children=(
                IR.Join(("s_suppkey", "s_nationkey"), ("l_suppkey", "c_nationkey"), "inner", children=(
                    IR.Join(("n_nationkey",), ("s_nationkey",), "inner", children=(
                        IR.Join(("r_regionkey",), ("n_regionkey",), "inner", children=(
                            IR.Filter(col("r_name") == E.lit("ASIA"), children=(T("region"),)),
                            T("nation"),
                        )),
                        T("supplier"),
                    )),
                    IR.HStack((E.NamedExpr("c_nationkey", col("c_nationkey")),), children=(
                        IR.Join(("o_orderkey",), ("l_orderkey",), "inner", children=(
                            IR.Join(("c_custkey",), ("o_custkey",), "inner", children=(
                                T("customer"),
                                IR.Filter((col("o_orderdate") >= E.Literal(lo)) & (col("o_orderdate") < E.Literal(hi)),
                                          children=(T("orders"),)),
                            )),
                            T("lineitem"),
                        )),
                    )),
                )),
            ),),
    ))


def build_q6(T, E, IR, col):
    lo = np.datetime64("1994-01-01")
    hi = np.datetime64("1995-01-01")
    return IR.GroupBy(
        (), (E.NamedExpr("revenue", (col("l_extendedprice") * col("l_discount")).sum()),),
        children=(
            IR.Filter(
                (col("l_shipdate") >= E.Literal(lo)) & (col("l_shipdate") < E.Literal(hi))
                & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                & (col("l_quantity") < 24.0),
                children=(T("lineitem"),)),
        ),)


# ---------------------------------------------------------------- phase 1
def build(gpu: str) -> None:
    import shutil

    from cudf_tpu_torch import kernels

    shutil.rmtree(kernels.BUILD, ignore_errors=True)  # build from the sources
    names = kernels.sources()
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
    from cudf_tpu_torch.kernels import stream_of

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
    log(f"launch-check: [{gpu}] host time a call (mean of 2000, no synchronize): "
        f"double {host_us(lambda: lc.double(x)):.2f} us, torch.mul "
        f"{host_us(lambda: torch.mul(x, 2.0)):.2f} us; the ctypes call alone (a host-only "
        f"entry point, onehot_groupby_blocks) {ctypes_us():.2f} us; the current stream's "
        f"handle by torch.cuda.current_stream().cuda_stream "
        f"{host_us(lambda: torch.cuda.current_stream().cuda_stream):.2f} us, by "
        f"kernels.stream_of {host_us(lambda: stream_of(x.device)):.2f} us")
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


SEG_ROWS = 1 << 27          # the h2o table's capacity: 1e8 rows padded to 2^27
SEG_GROUPS = 10_000          # q6's groups (id4 x id5), 10,000 rows each


def segment_reduce_inputs(n: int, groups: int, device):
    """q6's shape on the generic engine: sorted ids of ``groups`` groups of
    equal size over the first 1e8 rows (or n), then the padding in the
    overflow segment ``groups``; f64 values."""
    import torch

    live = min(n, 100_000_000)
    seg = torch.arange(live, device=device) // -(-live // groups)
    seg = torch.cat([seg, torch.full((n - live,), groups, device=device)])
    gen = torch.Generator(device=device).manual_seed(3)
    vals = torch.rand(n, device=device, generator=gen, dtype=torch.float64) * 100
    return seg, vals, groups + 1


def segment_reduce_vs_plain(gpu: str) -> dict:
    """The reduce-by-key kernel against its plain version (``scatter_reduce_``)
    at q6's shape: int64 counts, int64 and f64 min and max (a NaN in one
    group) in equal bits; the f64 sum within the source's bound of an exact
    sum (values k / 2^20, whose int64 sum is exact) and the same bits twice.
    Then the times of the f64 sum: kernel, plain version and
    ``torch.segment_reduce(lengths=)`` (the library yardstick, which the
    port never calls), beside the bound of its bytes."""
    import torch

    from cudf_tpu_torch.kernels import segment_reduce as sr

    dev = torch.device("cuda")
    seg, vals, nseg = segment_reduce_inputs(SEG_ROWS, SEG_GROUPS, dev)
    n = seg.numel()
    before = sr.segment_reduce.launches
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    ints = (vals * 1e6).to(torch.int64)
    nanv = vals.clone()
    nanv[12_345] = float("nan")
    for x, reduce, init in ((ones, "sum", 0), (ints, "amin", 2**63 - 1), (ints, "amax", -1),
                            (nanv, "amin", float("inf")), (nanv, "amax", float("-inf"))):
        got = sr.segment_reduce(x, seg, nseg, reduce, init)
        want = sr.segment_reduce_plain(x, seg, nseg, reduce, init)
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            raise AssertionError(f"segment_reduce: {reduce} of {x.dtype} differs from "
                                 f"scatter_reduce_")
    k = (vals * 2**30).to(torch.int64) - 2**36  # |k| < 2^37
    x = k.to(torch.float64) / 2**20
    got = sr.segment_reduce(x, seg, nseg, "sum", 0.0)
    exact = sr.segment_reduce_plain(k, seg, nseg, "sum", 0).to(torch.float64) / 2**20
    absum = sr.segment_reduce_plain(k.abs(), seg, nseg, "sum", 0).to(torch.float64) / 2**20
    d = 29 * 3 + 1  # 3 levels at 2^27 rows
    bound = d * 2.0**-53 * absum + exact.abs() * 2.0**-53
    used = float(((got - exact).abs() / bound.clamp(min=1e-300)).max())
    if used > 1:
        raise AssertionError(f"segment_reduce: the f64 sum is {used:.3f} of its bound")
    if not torch.equal(got.view(torch.int64),
                       sr.segment_reduce(x, seg, nseg, "sum", 0.0).view(torch.int64)):
        raise AssertionError("segment_reduce: two f64 sums differ")
    calls = sr.segment_reduce.launches - before
    if sr.contract_broken():
        raise AssertionError("segment_reduce: sorted ids set the contract's flag")
    bad = seg.clone()
    bad[SEG_ROWS // 2] = -1
    sr.segment_reduce(vals, bad, nseg, "sum", 0.0)
    if not sr.contract_broken():
        raise AssertionError("segment_reduce: an id out of order left the flag clear")
    log(f"kernels: segment_reduce matches scatter_reduce_ at q6's shape ({n} rows, {nseg} "
        f"segments): int64 count, int64 and f64 (a NaN) min and max in equal bits; the f64 "
        f"sum within {used:.4f} of its bound (d = {d}) and the same bits twice ({calls} "
        f"calls); an id out of order set the contract's flag, sorted ids left it clear")

    ms = cuda_ms(lambda: sr.segment_reduce(vals, seg, nseg, "sum", 0.0))
    plain_ms = cuda_ms(lambda: sr.segment_reduce_plain(vals, seg, nseg, "sum", 0.0), 5)
    lengths = torch.bincount(seg, minlength=nseg)
    library_ms = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths))
    nbytes = n * (8 + 8) + nseg * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"kernels: [{gpu}] segment_reduce f64 sum, N={n}, {nseg} segments, sorted ids: "
        f"kernel {ms:.4f} ms, plain (scatter_reduce_) {plain_ms:.4f} ms, "
        f"torch.segment_reduce(lengths=) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e9:.4f} GB at 3.35 TB/s), {100 * bound_ms / ms:.1f}% of it")
    return {"name": "segment_reduce", "route": "cuda",
            "source": "cudf_tpu_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "none (torch's scatter_reduce_; the reference uses XLA's segment_sum)",
            "launches": 0, "max_abs_err": float((got - exact).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


H2O_ROWS = 4_000_000


def segment_reduce_h2o(gpu: str) -> dict:
    """The db-benchmark's q6 (median and std of v3 by id4 and id5: the
    generic engine) and q7 (max v1 - min v2 by the string key id3: the sort
    lane) through the DataFrame on H2O_ROWS rows of G1's distributions (K =
    100, id3 over 40,000 labels), against pandas; the reduction's launches
    zeroed before each question and read after it, one or more each.
    Returns them by question."""
    import torch

    import cudf_tpu_torch as ctt
    from cudf_tpu_torch.kernels import segment_reduce as sr

    rng = np.random.default_rng(7)
    n = H2O_ROWS
    labels = np.char.add("id", np.char.zfill(np.arange(1, n // 100 + 1).astype(str), 10))
    pdf = pd.DataFrame({"id3": labels[rng.integers(0, len(labels), n)],
                        "id4": rng.integers(1, 101, n), "id5": rng.integers(1, 101, n),
                        "v1": rng.integers(1, 6, n), "v2": rng.integers(1, 16, n),
                        "v3": rng.uniform(0, 100, n).round(6)})
    frame = ctt.from_pandas(pdf)

    def q6(df):
        return df.groupby(["id4", "id5"]).agg({"v3": ["median", "std"]})

    def q7(df):
        out = df.groupby("id3", as_index=False).agg({"v1": "max", "v2": "min"})
        out["range_v1_v2"] = out["v1"] - out["v2"]
        return out[["id3", "range_v1_v2"]]

    launches = {}
    got = {}
    for name, q in (("q6", q6), ("q7", q7)):
        sr.segment_reduce.launches = 0
        got[name] = q(frame).to_pandas()
        launches[name] = sr.segment_reduce.launches
        if launches[name] < 1:
            raise AssertionError(f"h2o {name}: the segment reduction did not launch")
    want6 = q6(pdf)
    want6.columns = ["v3_median", "v3_std"]
    pd.testing.assert_frame_equal(got["q6"], want6, check_exact=False, rtol=1e-12)
    want7 = q7(pdf)
    if not (np.array_equal(got["q7"]["id3"].to_numpy(), want7["id3"].to_numpy())
            and np.array_equal(got["q7"]["range_v1_v2"].to_numpy(),
                               want7["range_v1_v2"].to_numpy())):
        raise AssertionError("h2o q7: differs from pandas")
    del frame
    torch.cuda.empty_cache()
    log(f"kernels: [{gpu}] h2o q6 and q7 through the DataFrame at {n} rows equal pandas "
        f"(q6 rtol 1e-12, q7 exact, {len(want7)} groups); segment_reduce launches: q6 "
        f"{launches['q6']}, q7 {launches['q7']}")
    return launches


DENSE_Q1_ROWS = 177_000_000  # TPC-H Q1's rows after its filter at SF30
DENSE_Q1_CAP = 1 << 28       # their capacity
DENSE_Q4_ROWS = 100_000_000  # the db-benchmark's G1_1e8


def dense_groupby_inputs(shape: str, device):
    """The dense lane's kernel arguments at (q1) TPC-H Q1's shape at SF30:
    DENSE_Q1_ROWS of DENSE_Q1_CAP rows, two int32 code keys (l_returnflag's 3
    codes, l_linestatus' 2: 8 slots, Q1's 4 groups in Q1_SHARES) and five
    float64 columns summed; or (q4) the db-benchmark's q4 (means of v1, v2,
    v3 by id4): 1e8 rows, id4 int32 in 1..100 (128 slots), v1 and v2 int32
    in 1..5 and 1..15, v3 float64. Float values are k / 2^20 for int64 k
    (``ks``), so an int64 sum of k over 2^20 is a float sum's exact value.
    Returns (keys, accs, n, slots, ks by accumulator)."""
    import torch

    from cudf_tpu_torch.kernels import dense_groupby as dg

    gen = torch.Generator(device=device).manual_seed(20)
    if shape == "q1":
        n, cap = DENSE_Q1_ROWS, DENSE_Q1_CAP
        edges = torch.tensor(np.cumsum(Q1_SHARES / Q1_SHARES.sum())[:-1], device=device)
        g = torch.bucketize(torch.rand(cap, device=device, generator=gen,
                                       dtype=torch.float64), edges)
        groups = torch.tensor(Q1_GROUPS, device=device)[g]
        keys = [dg.Key(groups[:, 0].contiguous(), None, 0, 2, 3, 3),
                dg.Key(groups[:, 1].contiguous(), None, 0, 1, 2, 2)]
        del g, groups
        ks = {j: torch.randint(0, 1 << 32, (cap,), device=device, generator=gen)
              for j in range(1, 6)}
        accs = [dg.Acc(dg.ROWS)] + [dg.Acc(dg.SUM_F, ks[j].double() / 2**20)
                                    for j in range(1, 6)]
        return keys, accs, n, 8, ks
    n = DENSE_Q4_ROWS
    id4 = torch.randint(1, 101, (n,), device=device, generator=gen, dtype=torch.int32)
    v1 = torch.randint(1, 6, (n,), device=device, generator=gen, dtype=torch.int32)
    v2 = torch.randint(1, 16, (n,), device=device, generator=gen, dtype=torch.int32)
    ks = {3: torch.randint(0, 100 << 20, (n,), device=device, generator=gen)}
    accs = [dg.Acc(dg.ROWS), dg.Acc(dg.SUM_I, v1), dg.Acc(dg.SUM_I, v2),
            dg.Acc(dg.SUM_F, ks[3].double() / 2**20)]
    return [dg.Key(id4, None, 1, 7, 100, 100)], accs, n, 128, ks


def dense_groupby_vs_plain(gpu: str) -> dict:
    """The dense-slot kernel against its plain version on the card at TPC-H
    Q1's shape (the thread tier) and the db-benchmark q4's (the warp
    tier): row counts and integer sums in equal bits, each float64 sum
    within m·eps·Σ|x| of its exact value for a slot of m rows, the same bits
    on a second launch; then the kernel's time beside the bound of its bytes,
    the plain version's and one f64 ``index_add_`` of every accumulator's
    terms (the library yardstick, which the port never calls); at Q1's shape
    the warp tier's time too, forced, which every shape could take. Then Q1's
    groupby through ``groupby_aggregate`` on the same columns, by the dense
    lane and by the sort lane (the dense lane switched off), in turns: equal
    keys and counts, sums within both lanes' bounds, warm times."""
    import torch

    from cudf_tpu_torch.kernels import dense_groupby as dg

    dev = torch.device("cuda")
    out = {"name": "dense_groupby", "route": "cuda",
           "source": "cudf_tpu_torch/kernels/csrc/dense_groupby.cu",
           "replaces": "none (the sort lane: torch.sort, gathers, segment_reduce)",
           "launches": 0, "bound_by": "bytes"}
    eps = 2.0 ** -53
    for shape in ("q1", "q4"):
        keys, accs, n, slots, ks = dense_groupby_inputs(shape, dev)
        before = dg.dense_groupby.launches
        got = dg.dense_groupby(keys, accs, n, slots, True)
        if not torch.equal(got, dg.dense_groupby(keys, accs, n, slots, True)):
            raise AssertionError(f"dense_groupby {shape}: two launches differ")
        want = dg.dense_groupby_plain(keys, accs, n, slots, True)
        used = 0.0
        for j, a in enumerate(accs):
            if a.kind != dg.SUM_F:
                if not torch.equal(got[:, j], want[:, j]):
                    raise AssertionError(f"dense_groupby {shape}: accumulator {j} differs "
                                         f"from its plain version")
                continue
            exact = dg.dense_groupby_plain(keys, [dg.Acc(dg.ROWS), dg.Acc(dg.SUM_I, ks[j])],
                                           n, slots, True)[:, 1].double() / 2**20
            bound = got[:, 0].double() * eps * exact  # the terms are non-negative
            err = (got[:, j].view(torch.float64) - exact).abs()
            used = max(used, float((err / bound.clamp(min=1e-300)).max()))
        if used > 1:
            raise AssertionError(f"dense_groupby {shape}: a float64 sum is {used:.3f} of "
                                 f"its bound")
        tier = dg.tier(slots, [a.kind for a in accs])
        log(f"kernels: dense_groupby matches its plain version at {shape}'s shape ({n} rows, "
            f"{slots} slots, {len(accs)} accumulators, {'thread tier' if tier == 0 else f'warp tier, {tier} warps'}): "
            f"counts and integer sums in equal bits, float64 sums within {used:.4f} of "
            f"their bound, the same bits twice ({dg.dense_groupby.launches - before} "
            f"launches)")
        ms = cuda_ms(lambda: dg.dense_groupby(keys, accs, n, slots, True))
        plain_ms = cuda_ms(lambda: dg.dense_groupby_plain(keys, accs, n, slots, True), 3)
        slot = sum((k.data[:n].long() - int(k.vmin)) << sum(x.width for x in keys[i + 1:])
                   for i, k in enumerate(keys))
        terms = torch.stack([torch.ones(n, dtype=torch.float64, device=dev)]
                            + [a.data[:n].double() for a in accs[1:]], 1)
        acc = torch.zeros(slots, len(accs), dtype=torch.float64, device=dev)
        library_ms = cuda_ms(lambda: acc.index_add_(0, slot, terms), 3)
        del slot, terms, acc
        nbytes = (n * (sum(k.data.element_size() for k in keys)
                       + sum(a.data.element_size() for a in accs[1:]))
                  + slots * len(accs) * 8)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"kernels: [{gpu}] dense_groupby at {shape}'s shape: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, f64 index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes / 1e9:.4f} GB at 3.35 TB/s), {100 * bound_ms / ms:.1f}% of it")
        if shape == "q1":
            thread_tier = dg.tier
            dg.tier = lambda k, kinds: dg._WARPS
            try:
                if not torch.equal(got[:, 0], dg.dense_groupby(keys, accs, n, slots, True)[:, 0]):
                    raise AssertionError("dense_groupby q1: the warp tier's counts differ")
                warp_ms = cuda_ms(lambda: dg.dense_groupby(keys, accs, n, slots, True))
            finally:
                dg.tier = thread_tier
            log(f"kernels: [{gpu}] dense_groupby at q1's shape by the warp tier "
                f"({dg._WARPS} warps), forced: {warp_ms:.4f} ms against the thread tier's "
                f"{ms:.4f} ms")
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms,
                       bound_used=float(used), warp_tier_ms=warp_ms)
            dense_q1_lanes(gpu, keys, accs, n)
        else:
            out.update(q4_ms=ms, q4_plain_ms=plain_ms, q4_bound_ms=bound_ms,
                       q4_library_ms=library_ms)
        del keys, accs, ks, got, want
        torch.cuda.empty_cache()
    return out


def dense_q1_lanes(gpu: str, keys, accs, n: int) -> None:
    """Q1's groupby (sums of the five columns, means of three, the size) through
    ``groupby_aggregate`` on the kernel's own columns: the dense lane, then
    the sort lane with the dense lane switched off, in turns (host clock
    ending in a synchronize, best of 2): equal keys and sizes, each sum and
    mean within both lanes' bounds of each other; the dense lane's device
    breakdown."""
    import torch

    from cudf_tpu_torch import AggSpec, Column, Table, groupby_aggregate
    from cudf_tpu_torch.core import dtypes
    from cudf_tpu_torch.kernels import dense_groupby as dg
    from cudf_tpu_torch.ops import densegroup

    names = ["l_quantity", "l_extendedprice", "disc_price", "charge", "l_discount"]
    cols = {"l_returnflag": Column(dtypes.int32, keys[0].data, None, n),
            "l_linestatus": Column(dtypes.int32, keys[1].data, None, n)}
    cols.update({c: Column(dtypes.float64, a.data, None, n) for c, a in zip(names, accs[1:])})
    tbl = Table(cols)
    aggs = ([AggSpec(c, "sum", f"sum_{c}") for c in names[:4]]
            + [AggSpec(c, "mean", f"avg_{c}") for c in ("l_quantity", "l_extendedprice",
                                                         "l_discount")]
            + [AggSpec("", "size", "count_order")])
    real = densegroup.dense_groupby
    lanes = {"dense": real, "sort": lambda *a, **k: None}
    answers, times = {}, {n_: [] for n_ in lanes}
    for name in ["dense", "sort", "sort", "dense"]:
        densegroup.dense_groupby = lanes[name]
        try:
            before = dg.dense_groupby.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = groupby_aggregate(tbl, KEYS, aggs)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if (dg.dense_groupby.launches > before) != (name == "dense"):
                raise AssertionError(f"dense Q1: the {name} lane's launches")
        finally:
            densegroup.dense_groupby = real
        answers[name] = res.to_pandas()
    d, s = answers["dense"], answers["sort"]
    if not (d[KEYS + ["count_order"]].equals(s[KEYS + ["count_order"]])):
        raise AssertionError("dense Q1: keys or sizes differ between the lanes")
    m = d["count_order"].to_numpy().astype(np.float64)
    eps = 2.0 ** -53
    for c in d.columns[len(KEYS):-1]:
        g, w = d[c].to_numpy(), s[c].to_numpy()  # sums of non-negative terms
        if not (np.abs(g - w) <= 2 * m * eps * np.abs(w)).all():
            raise AssertionError(f"dense Q1: {c} differs beyond the lanes' bounds")
    log(f"dense Q1: [{gpu}] groupby_aggregate of {n} rows -> {len(d)} groups, both lanes "
        f"agree (keys and sizes exact, sums and means within 2·m·eps); warm, host clock "
        f"ending in a synchronize, in turns: dense {' / '.join(f'{t:.2f}' for t in times['dense'])} "
        f"ms, sort {' / '.join(f'{t:.2f}' for t in times['sort'])} ms")
    log(f"dense Q1: [{gpu}] dense lane device breakdown: "
        + device_breakdown(lambda: groupby_aggregate(tbl, KEYS, aggs)))


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
    return tbl, launches, out


# ---------------------------------------------------------------- phase 4
def sort_lane(gpu: str, tbl, df) -> int:
    """Returns the segment reduction's launches in the argmin lanes."""
    import torch

    from cudf_tpu_torch import AggSpec, Column, Table, groupby_aggregate
    from cudf_tpu_torch.kernels import onehot_groupby as k
    from cudf_tpu_torch.kernels import segment_reduce as sr

    kinds = ["sum", "mean", "min", "max", "var"]
    aggs = [AggSpec("l_extendedprice", kind, kind) for kind in kinds]
    full, df = df, df.iloc[:CUT_ROWS]
    t = Table({"l_orderkey": Column.from_numpy(df["l_orderkey"].to_numpy()),
               "l_extendedprice": tbl["l_extendedprice"].slice(0, CUT_ROWS)})
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
    # Each group's sum adds only its own rows (sortprim.segment_reduce, the
    # reduce-by-key kernel), so a term of a group of m rows goes through at
    # most m - 1 additions in any order: the error is within c·eps·Σ_group|x|
    # with c = m, the group's own row count (1 to 7 here). The sum is then
    # rounded to f32 (2^-23 relative); mean is the f64 sum over the count.
    # The var is two-pass (a sum of (x - group mean)^2), within
    # c·eps·Σ_group x² of its M2.
    eps = np.finfo(np.float64).eps
    _, inv = np.unique(df["l_orderkey"].to_numpy(), return_inverse=True)
    cnt = want["count"].to_numpy()
    rows = np.bincount(inv)
    atol_sum = rows * eps * np.bincount(inv, weights=np.abs(p))
    used = {}
    for name, atol, rtol in (("sum", atol_sum, 2.0 ** -23),
                             ("mean", atol_sum / cnt, 1e-12)):
        got_v, want_v = out[name].to_numpy(np.float64), want[name].to_numpy()
        err = np.abs(got_v - want_v)
        used[name] = float((err / (rtol * np.abs(want_v) + atol)).max())
        if used[name] > 1:
            raise AssertionError(f"{name} off by {err.max()} (beyond the per-group bound)")
    atol_m2 = rows * eps * np.bincount(inv, weights=p * p)
    gv, wv = out["var"].to_numpy(), want["var"].to_numpy()
    if not np.array_equal(np.isnan(gv), np.isnan(wv)):
        raise AssertionError("var null pattern differs")
    ok = ~np.isnan(wv)
    err = np.abs(gv[ok] - wv[ok])
    used["var"] = float((err / (1e-12 * np.abs(wv[ok])
                                + atol_m2[ok] / np.maximum(cnt[ok] - 1, 1))).max())
    if used["var"] > 1:
        raise AssertionError(f"var off by {err.max()} (beyond the per-group bound)")
    log(f"sort: matches pandas groupby(sort=True): {len(out)} groups, keys and "
        f"min/max exact, sum/mean/var within the per-group bound (m·eps·Σ_group|x| "
        f"on the sum; worst error {used['sum']:.3f} of the bound for sum, "
        f"{used['mean']:.3f} for mean, {used['var']:.3f} for var)")
    log(f"sort: [{gpu}] warm groupby profile: "
        + device_breakdown(lambda: groupby_aggregate(t, ["l_orderkey"], aggs)))
    before = k.groupby_sum_count.launches
    sr.segment_reduce.launches = 0
    arg_lanes(gpu, "a", t, df[["l_orderkey", "l_extendedprice"]], ["l_orderkey"])
    arg_lanes(gpu, "b", tbl, full[KEYS + ["l_extendedprice"]], KEYS)
    launches = sr.segment_reduce.launches
    if k.groupby_sum_count.launches != before:
        raise AssertionError("an argmin/argmax lane launched the one-hot kernel")
    if launches < 1:
        raise AssertionError("the argmin/argmax lanes did not launch the segment reduction")
    log(f"argmin: segment_reduce launches in (a) and (b): {launches}")
    return launches


ARG_RUNS = 2  # warm runs a lane, in turns: each lane once forward, then once backward
ARG_LANES = ("sort_groupby", "wide_groupby", "generic_groupby")


def _dispatched(fn):
    """fn()'s result and the groupby lanes that answered inside it."""
    from cudf_tpu_torch.ops import fastgroup, sortgroup, widegroup
    from cudf_tpu_torch.ops import groupby as gb

    answered = []
    # the wide lane counts its own answers (wide_groupby.launches)
    patched = [(fastgroup, "_onehot_groupby"), (sortgroup, "sort_groupby"),
               (gb, "generic_groupby")]
    inners = [getattr(m, n) for m, n in patched]
    wide = widegroup.wide_groupby.launches

    def spy(name, inner):
        def lane(*a, **kw):
            out = inner(*a, **kw)
            if out is not None:
                answered.append(name)
            return out
        return lane

    try:
        for (m, n), inner in zip(patched, inners):
            setattr(m, n, spy(n, inner))
        out = fn()
    finally:
        for (m, n), inner in zip(patched, inners):
            setattr(m, n, inner)
    answered += ["wide_groupby"] * (widegroup.wide_groupby.launches - wide)
    return out, answered


def arg_lanes(gpu: str, what: str, tbl, frame, keys) -> None:
    """argmin and argmax of l_extendedprice by ``keys`` (dropna) through
    each code-sort lane, called directly on ``tbl``: every answer exact
    against pandas' idxmin/idxmax of ``frame`` (the same rows) in every
    group with a value, ties to the first row, and the lanes bit for bit
    against each other in every group; warm times in turns, host clock
    ending in a synchronize; the lane groupby_aggregate takes; the fastest
    lane's device profile."""
    import torch

    from cudf_tpu_torch import AggSpec, groupby_aggregate
    from cudf_tpu_torch.ops import sortgroup, widegroup
    from cudf_tpu_torch.ops import groupby as gb

    t_start = time.perf_counter()
    aggs = [AggSpec("l_extendedprice", "argmin", "argmin"),
            AggSpec("l_extendedprice", "argmax", "argmax")]
    fns = {"sort_groupby": sortgroup.sort_groupby, "wide_groupby": widegroup.wide_groupby,
           "generic_groupby": gb.generic_groupby}
    lanes = {n: (lambda f=fns[n]: f(tbl, keys, aggs, True)) for n in ARG_LANES}
    answers = {}
    for name, fn in lanes.items():
        out = fn()
        if out is None:
            raise AssertionError(f"argmin {what}: {name} refused argmin/argmax")
        answers[name] = _host_columns(out)
        del out
    times = {n: [] for n in ARG_LANES}
    for name in (list(ARG_LANES) + list(ARG_LANES)[::-1]) * (ARG_RUNS // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lanes[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    out, answered = _dispatched(lambda: groupby_aggregate(tbl, keys, aggs))
    if len(answered) != 1:
        raise AssertionError(f"argmin {what}: the dispatch's lanes {answered}")
    answers["groupby_aggregate"] = _host_columns(out)
    del out
    first = answers["sort_groupby"]
    for name, got in answers.items():
        for col, (w, wn) in first.items():
            g, gn = got[col]
            if not (np.array_equal(g, w) and np.array_equal(gn, wn)):
                raise AssertionError(f"argmin {what}: {name}'s {col} differs from "
                                     f"sort_groupby's")
    p = frame["l_extendedprice"]
    t0 = time.perf_counter()
    want = frame[p.notna()].groupby(keys, sort=True)["l_extendedprice"].agg(
        ["idxmin", "idxmax"])
    oracle_s = time.perf_counter() - t0
    has = ~first["argmin"][1]
    for i, key in enumerate(keys):
        level = want.index.get_level_values(i) if len(keys) > 1 else want.index
        if not np.array_equal(first[key][0][has], level.to_numpy(np.int64)):
            raise AssertionError(f"argmin {what}: the groups with a value differ from "
                                 f"pandas' ({key})")
    for col, ref in (("argmin", "idxmin"), ("argmax", "idxmax")):
        if not np.array_equal(first[col][0][has], want[ref].to_numpy(np.int64)):
            raise AssertionError(f"argmin {what}: {col} differs from pandas' {ref}")
    best = {n: min(ts) for n, ts in times.items()}
    line = ", ".join(f"{n} {' / '.join(f'{t:.2f}' for t in ts)} ms"
                     for n, ts in times.items())
    log(f"argmin {what}: [{gpu}] {tbl.num_rows} rows by {keys} -> {len(first['argmin'][0])} "
        f"groups; argmin and argmax of l_extendedprice equal pandas' idxmin/idxmax in "
        f"all {int(has.sum())} groups with a value, and the {len(answers)} answers "
        f"({len(ARG_LANES)} lanes and the dispatch) equal bit for bit in every group; "
        f"{time.perf_counter() - t_start:.1f} s so far, pandas {oracle_s:.1f} s of it "
        f"(host clock)")
    log(f"argmin {what}: [{gpu}] warm, host clock ending in a synchronize, in turns: "
        f"{line}")
    winner = min(best, key=best.get)
    log(f"argmin {what}: [{gpu}] fastest lane {winner} (best of {ARG_RUNS}); "
        f"groupby_aggregate takes {answered[0]}")
    log(f"argmin {what}: [{gpu}] {winner} device breakdown: "
        + device_breakdown(lanes[winner]))


# ---------------------------------------------------------------- phase 12
# The frame phase runs beside the phases whose data it reuses: the README
# quick start and the Series ops on phase 3's frame, DataFrame.merge on
# phase 5's tables, and the frame over parquet on phase 11's scan file.
def frame_readme(gpu: str, df):
    """The README quick start through the port's DataFrame at 60M rows:
    from_pandas -> dropna -> groupby(KEYS).agg(mean, sum, size) ->
    to_pandas, against pandas. After dropna the f32 value column holds no
    NaN or null, so the one-hot kernel takes it as itself (V = 1). Then the
    same groupby without dropna over a value column with a NaN in every
    50th row: the frame turns the NaNs into nulls and the kernel takes the
    column with its mask (V = 2: valid sum, valid count, row count).
    Returns the frame, the one-hot kernel's launches in the two runs and
    the phase's seconds."""
    import torch

    import cudf_tpu_torch as ctt
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as k
    from cudf_tpu_torch.utils.padding import bucket_capacity

    t_start = time.perf_counter()
    q1 = df[KEYS + ["l_extendedprice"]]
    aggs = dict(avg=("l_extendedprice", "mean"), s=("l_extendedprice", "sum"),
                n=("l_extendedprice", "size"))

    def run(frame):
        return frame.dropna().groupby(KEYS).agg(**aggs)

    k.groupby_sum_count.launches = 0
    ht.probe_table.launches = 0
    t0 = time.perf_counter()
    frame = ctt.from_pandas(q1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = run(frame).to_pandas()
    t2 = time.perf_counter()
    launches = k.groupby_sum_count.launches
    if launches < 1:
        raise AssertionError("the README quick start did not launch the one-hot kernel")
    if ht.probe_table.launches:
        raise AssertionError("the README quick start launched the probe kernel")
    _, warm_s = synced(lambda: run(frame))
    log(f"frame: [{gpu}] ctt.from_pandas({len(q1)} rows) {t1 - t0:.3f} s; "
        f"dropna().groupby().agg(mean, sum, size).to_pandas() {t2 - t1:.3f} s "
        f"(first), {warm_s * 1e3:.2f} ms warm without to_pandas (host clock, "
        f"synchronized); one-hot kernel launches {launches}")

    want = (q1.dropna().astype({"l_extendedprice": np.float64})
            .groupby(KEYS, sort=True)["l_extendedprice"].agg(["mean", "sum", "size"]))
    np.testing.assert_array_equal(out.index.to_frame().to_numpy(np.int64),
                                  want.index.to_frame().to_numpy(np.int64))
    np.testing.assert_array_equal(out["n"].to_numpy(), want["size"].to_numpy())
    np.testing.assert_allclose(out["avg"], want["mean"], rtol=1e-6)
    np.testing.assert_allclose(out["s"], want["sum"], rtol=1e-5)
    if not np.isfinite(out[["avg", "s"]].to_numpy()).all():
        raise AssertionError("frame: non-finite aggregates")
    log(f"frame: the README quick start matches pandas: {len(out)} groups, keys and "
        f"sizes exact, mean rtol 1e-6, sum rtol 1e-5")

    # the value column with NaNs, no dropna: the one-hot lane at V = 2
    keep = np.arange(len(q1)) % 50 != 0
    nan_frame = frame.copy()
    nan_frame["l_extendedprice"] = frame["l_extendedprice"].where(ctt.Series(keep), np.nan)
    before = k.groupby_sum_count.launches

    def run_nan():
        return nan_frame.groupby(KEYS).agg(c=("l_extendedprice", "count"), **aggs)

    t3 = time.perf_counter()
    out = run_nan().to_pandas()
    t4 = time.perf_counter()
    nan_launches = k.groupby_sum_count.launches - before
    if nan_launches < 1:
        raise AssertionError("the groupby over NaN values did not launch the one-hot kernel")
    launches += nan_launches
    _, nan_warm_s = synced(run_nan)
    log(f"frame: [{gpu}] groupby().agg(count, mean, sum, size) over values with NaNs "
        f"(V = 2) .to_pandas() {t4 - t3:.3f} s (first), {nan_warm_s * 1e3:.2f} ms warm "
        f"without to_pandas (host clock, synchronized); one-hot kernel launches "
        f"{nan_launches}")
    q1n = q1.astype({"l_extendedprice": np.float64})
    q1n.loc[~keep, "l_extendedprice"] = np.nan
    want = q1n.groupby(KEYS, sort=True)["l_extendedprice"].agg(["count", "mean", "sum",
                                                                "size"])
    np.testing.assert_array_equal(out.index.to_frame().to_numpy(np.int64),
                                  want.index.to_frame().to_numpy(np.int64))
    np.testing.assert_array_equal(out["n"].to_numpy(), want["size"].to_numpy())
    np.testing.assert_array_equal(out["c"].to_numpy(), want["count"].to_numpy())
    np.testing.assert_allclose(out["avg"], want["mean"], rtol=1e-6)
    np.testing.assert_allclose(out["s"], want["sum"], rtol=1e-5)
    log(f"frame: the groupby over NaN values matches pandas: {len(out)} groups, keys, "
        f"sizes and counts exact, mean rtol 1e-6, sum rtol 1e-5")
    del nan_frame, q1n

    # the kernel at the frame path's shape: V = 2 (where(valid, v, 0), valid)
    n_active = int(q1[KEYS].notna().all(axis=1).sum())
    cap = bucket_capacity(n_active)
    gid, vals, w, K = onehot_inputs(cap, n_active, 2, torch.device("cuda"))
    vals2 = torch.cat([vals, torch.ones_like(vals)], 1)
    err = _check_onehot(k, gid, vals2, w, K, True)
    ms = cuda_ms(lambda: k.groupby_sum_count(gid, vals2, w, K))
    plain_ms = cuda_ms(lambda: k.groupby_sum_count_plain(gid, vals2, w, K), iters=5)
    n_in = int((gid >= 0).sum())
    nbytes = cap * 4 + n_in * (4 * 2 + 4) + K * 3 * 8
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n_in * 8 / F32_FLOPS) * 1e3
    log(f"frame: [{gpu}] onehot_groupby_sum_count at the frame path's shape N={cap} "
        f"({n_in} rows in range) V=2 K={K} (shared tier, K(V+1) = {K * 3}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e9:.4f} GB at 3.35 TB/s); equals its plain version, "
        f"max_abs_err={err}")
    return frame, launches, time.perf_counter() - t_start


def frame_series(gpu: str, df, frame) -> float:
    """Series ops at 60M rows on the frame's l_extendedprice, each against
    pandas: shift(1) and diff() exactly, rolling(7).mean() at rtol 1e-5 (a
    window's sum is a difference of f64 prefix sums over 60M rows, as in
    the reference: ~1e-7 of a window's sum);
    DataFrame.hash_values() against the port's CPU path on the first 1M
    rows; a categorical round trip of l_returnflag and its astype("category")
    on the card. Returns the seconds."""
    import cudf_tpu_torch as ctt

    t_start = time.perf_counter()
    p = df["l_extendedprice"]
    s = frame["l_extendedprice"]
    times = {}
    for name, fn, want, rtol in (
            ("shift(1)", lambda: s.shift(1), lambda: p.shift(1), 0),
            ("diff()", lambda: s.diff(), lambda: p.diff(), 0),
            ("rolling(7).mean()", lambda: s.rolling(7).mean(),
             lambda: p.rolling(7).mean(), 1e-5)):
        got, times[name] = synced(fn)
        g, w = got.to_pandas().to_numpy(np.float64), want().to_numpy(np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol, equal_nan=True, err_msg=name)
    h, times["hash_values()"] = synced(lambda: frame.hash_values())
    n = 1_000_000
    cpu = ctt.from_pandas(df[KEYS + ["l_extendedprice"]].iloc[:n], device="cpu")
    np.testing.assert_array_equal(h.to_numpy()[:n], cpu.hash_values().to_numpy())
    cat = df["l_returnflag"].astype("category")
    back, times["categorical round trip"] = synced(lambda: ctt.Series(cat).to_pandas())
    if not (np.array_equal(back.cat.codes.to_numpy(), cat.cat.codes.to_numpy())
            and list(back.cat.categories) == list(cat.cat.categories)
            and back.cat.ordered == cat.cat.ordered):
        raise AssertionError("frame: the categorical round trip changed l_returnflag")
    fac, times["astype('category')"] = synced(
        lambda: frame["l_returnflag"].astype("category"))
    fac = fac.to_pandas()
    if not (np.array_equal(fac.cat.codes.to_numpy(), cat.cat.codes.to_numpy())
            and list(fac.cat.categories) == list(cat.cat.categories)):
        raise AssertionError("frame: astype('category') on the card differs from pandas")
    log(f"frame: [{gpu}] Series over {len(p)} rows equal pandas (shift, diff exact; "
        f"rolling mean rtol 1e-5), hash_values equals the CPU path on {n} rows, the "
        f"categorical round trip and astype('category') are exact; " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in times.items())
        + " (host clock, synchronized, first call)")
    return time.perf_counter() - t_start


def frame_merge(gpu: str, li, filtered, want) -> tuple:
    """DataFrame.merge of lineitem (60M) with the filtered orders through the
    hash lane, row for row against the numpy oracle, then sort_values by
    (l_orderkey, l_extendedprice): its first and last rows and their
    labels. Returns the probe kernel's launches in the merge and the
    seconds."""
    import torch

    import cudf_tpu_torch as ctt
    from cudf_tpu_torch.kernels import hashtable as ht

    t_start = time.perf_counter()
    left, right = ctt.DataFrame(li), ctt.DataFrame(filtered)
    ht.probe_table.launches = 0
    merged, merge_s = synced(lambda: left.merge(right, left_on="l_orderkey",
                                                right_on="o_orderkey"))
    launches = ht.probe_table.launches
    if launches < 1:
        raise AssertionError("DataFrame.merge did not launch the probe kernel")
    assert_rows(_columns(merged.table, JOIN_COLS), want, "frame merge", False)
    srt, sort_s = synced(lambda: merged.sort_values(["l_orderkey", "l_extendedprice"]))
    order = np.lexsort((want["l_extendedprice"], want["l_orderkey"]))
    for end, pos in ((srt.head(1), order[0]), (srt.tail(1), order[-1])):
        row = end.to_pandas()
        if int(row.index[0]) != pos or any(row[c].iloc[0] != want[c][pos]
                                           for c in JOIN_COLS):
            raise AssertionError(f"frame sort_values: row {row} is not the oracle's {pos}")
    torch.cuda.synchronize()
    log(f"frame: [{gpu}] DataFrame.merge {li.num_rows} x {filtered.num_rows} -> "
        f"{len(merged)} rows {merge_s * 1e3:.2f} ms, equal to the oracle row for row; "
        f"sort_values([l_orderkey, l_extendedprice]) {sort_s * 1e3:.2f} ms, first and "
        f"last rows and labels as the oracle's (host clock, synchronized); probe "
        f"launches {launches}")
    return launches, time.perf_counter() - t_start


def frame_scan(gpu: str, path: str, k, v) -> float:
    """The README quick start from a file: ctt.read_parquet(p).dropna()
    .groupby("k").agg(c=("v", "mean")).to_pandas() on the scan file (60M
    rows, 3M groups: the code-sort lane) against a numpy oracle, and
    ctt.read_parquet(p)["v"].sum() decoding only v. Returns the seconds."""
    import cudf_tpu_torch as ctt

    t_start = time.perf_counter()

    def one_column():
        df = ctt.read_parquet(path)
        return df, df["v"].sum()

    (df, total), sum_s = synced(one_column)
    if df.table.undecoded() != ["k", "w"]:
        raise AssertionError(f"frame scan: decoded more than v: {df.table.undecoded()}")
    want_sum = float(v.sum(dtype=np.float64))
    if abs(total - want_sum) > 1e-4 * float(np.abs(v).sum()):  # an f32 sum
        raise AssertionError(f"frame scan: sum {total}, numpy {want_sum}")
    out, first_s = synced(lambda: ctt.read_parquet(path).dropna().groupby("k")
                          .agg(c=("v", "mean")).to_pandas())
    cnt = np.bincount(k)
    keys = np.flatnonzero(cnt)
    mean = np.bincount(k, weights=v.astype(np.float64))[keys] / cnt[keys]
    np.testing.assert_array_equal(out.index.to_numpy(), keys)
    np.testing.assert_allclose(out["c"].to_numpy(), mean, rtol=1e-12)
    log(f"frame: [{gpu}] ctt.read_parquet(p)['v'].sum() {sum_s * 1e3:.2f} ms, k and w "
        f"never decoded; read_parquet(p).dropna().groupby('k').agg(c=('v', 'mean'))"
        f".to_pandas() {first_s * 1e3:.2f} ms for {len(out)} groups, keys exact and "
        f"means rtol 1e-12 against numpy (host clock, synchronized)")
    return time.perf_counter() - t_start


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
    ht.insert_table.launches = 0
    oh.groupby_sum_count.launches = 0
    t0 = time.perf_counter()
    ot = Table.from_pandas(od)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    filtered, out = q3(ot)
    got = out.to_pandas()
    t2 = time.perf_counter()
    launches = ht.probe_table.launches
    builds = ht.insert_table.launches
    if launches < 1:
        raise AssertionError("the join path did not launch the probe kernel")
    if builds < 1:
        raise AssertionError("the join path did not launch the insert kernel")
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
        f"filter+join warm {warm_s * 1e3:.2f} ms (host clock); probe launches {launches}, "
        f"insert launches {builds}")

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
    return li, filtered, launches, builds


# ---------------------------------------------------------------- phase 6
def join_general(gpu: str, li, filtered, want, match) -> None:
    import torch

    from cudf_tpu_torch import join
    from cudf_tpu_torch.kernels import hashtable as ht

    # the first CUT_ROWS lineitem rows; the oracle's rows are in lineitem order
    li = li.slice(0, CUT_ROWS)
    want = {c: v[: int(match[:CUT_ROWS].sum())] for c, v in want.items()}
    before = ht.probe_table.launches

    def run():
        # ordered=True: with ordered=False the swap would build on the
        # smaller, distinct side (filtered orders) and take the hash lane;
        # both lanes give left-row order, so the work is the same
        return join(filtered, li, ["o_orderkey"], ["l_orderkey"], "inner",
                    ordered=True)

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
        f"lineitem (the build side) -> {len(got)} rows, matches the "
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


def probe_reads(table, q1, q2, max_probe: int) -> tuple:
    """(S, sectors): the slot reads of probe_table(*table, q1, q2,
    max_probe=max_probe), each query's chain walked as probe_table_plain
    walks it (up to the first match or vacant slot, at most max_probe
    steps), and the distinct 32 B sectors those reads touch along each
    chain."""
    import torch

    from cudf_tpu_torch.kernels import hashtable as ht

    tk1, tk2, payload = table
    m = tk1.shape[0]
    base = tk1.data_ptr() // 16  # the slot tensor's first slot, in 16 B units
    h = ht._mix(q1, q2)
    done = torch.zeros(q1.shape, dtype=torch.bool, device=q1.device)
    reads = sectors = 0
    prev = None
    for i in range(max_probe):
        slot = (h + i) & (m - 1)
        sector = (base + slot.to(torch.int64)) >> 1
        reads += int((~done).sum().item())
        fresh = ~done if prev is None else ~done & (sector != prev)
        sectors += int(fresh.sum().item())
        p = payload[slot]
        vacant = p == ht.EMPTY
        done |= vacant | ((tk1[slot] == q1) & (tk2[slot] == q2))
        prev = sector
    return reads, sectors


def probe_vs_plain(gpu: str, li, filtered) -> dict:
    import torch

    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.ops import fastjoin

    dev = torch.device("cuda")
    n_edge = probe_edge_cases(ht, dev)
    built = fastjoin.build_hash_table([li["l_orderkey"]], [filtered["o_orderkey"]], False)
    if built is None:
        raise AssertionError("the main join's keys built no hash table")
    (q1, q2), table, n_build, _, max_probe = built
    if ht.slot_tensor(*table) is None:
        raise AssertionError("the main join's table is not in the slot layout")
    packs = ht.probe_table.packs
    got = ht.probe_table(*table, q1, q2, max_probe=max_probe)
    torch.cuda.synchronize()
    if ht.probe_table.packs != packs:
        raise AssertionError("the main join's table was packed before the probe")
    want = ht.probe_table_plain(*table, q1, q2, max_probe)
    max_err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    if max_err != 0:
        raise AssertionError("probe kernel disagrees with its plain version at the "
                             "main join's shape")
    log(f"kernels: hashtable_probe equals its plain version exactly on {n_edge} edge "
        f"cases (both layouts, a chain that wraps) and on the main join's table "
        f"(slot views, reached the kernel with no packing) and words")

    ms = cuda_ms(lambda: ht.probe_table(*table, q1, q2, max_probe=max_probe))
    plain_ms = cuda_ms(lambda: ht.probe_table_plain(*table, q1, q2, max_probe), iters=5)

    def packed(w1, w2):
        return (w2.to(torch.int64) << 32) | (w1.to(torch.int64) & 0xFFFFFFFF)

    occ = table[2] != ht.EMPTY
    build_keys = torch.sort(packed(table[0][occ], table[1][occ])).values
    probe_keys = packed(q1, q2)
    library_ms = cuda_ms(lambda: torch.searchsorted(build_keys, probe_keys))
    m, n = table[0].shape[0], q1.shape[0]
    reads, sectors = probe_reads(table, q1, q2, max_probe)
    # each chain starts at a hashed slot of a table far past the 50 MB L2,
    # so every 32 B sector it touches comes from HBM; a next slot in the
    # same sector (two slots a sector) moves nothing new. Plus two query
    # words read and the result written
    nbytes = 12 * n + 32 * sectors
    streamed = 12 * m + 12 * n  # the table read once in order: a looser limit
    ops = 12 * reads          # hash and one probe step's compares, 32-bit ALU ops
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    log(f"kernels: [{gpu}] hashtable_probe N={n} queries, m={m} slots for {n_build} "
        f"build rows, max_probe {max_probe}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, searchsorted "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
        f"3.35 TB/s: 12·N + 32·sectors for {sectors} distinct 32 B sectors along the "
        f"chains, {sectors / n:.4f} a query; S = {reads} slot reads, S/N = "
        f"{reads / n:.4f}, 12·N + 32·S {(12 * n + 32 * reads) / 1e9:.4f} GB); "
        f"streamed lower limit 12·m + 12·N {streamed / 1e9:.4f} GB, "
        f"{streamed / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return {"name": "hashtable_probe", "route": "cuda",
            "source": "cudf_tpu_torch/kernels/csrc/hashtable_probe.cu",
            "replaces": "cudf_tpu/kernels/hashtable.py:83",
            "launches": 0, "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / F32_FLOPS else "operations", "library_ms": library_ms}


def insert_vs_plain(gpu: str) -> dict:
    """The hash build's insert kernel against its plain version at the
    joins' largest builds: TPC-H SF30 Q21's 38.6M order keys (drawn
    distinct from [0, 2^28) on the card) in 2^27 slots, and q5's 4.5M
    customer keys 0..4,499,999 in 2^24, where the capped rounds leave a
    row unplaced. Each table holds every key once, found with its own
    probe bound; ``occupied`` is exact. Times (CUDA events, the wrapper
    with its one host read of the counts) beside the bound, the plain
    version's and the capped rounds' at two sizes, the build they
    replaced."""
    import torch

    from cudf_tpu_torch.kernels import hashtable as ht

    out = {}
    for what, n, m in (("q21_late_orders", 38_600_000, 1 << 27),
                       ("q5_customers", 4_500_000, 1 << 24)):
        g = torch.Generator(device="cuda").manual_seed(23)
        keys = (torch.randperm(1 << 28, device="cuda", generator=g)[:n].to(torch.int32)
                if n > 5_000_000 else torch.arange(n, dtype=torch.int32, device="cuda"))
        k2 = torch.zeros_like(keys)
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        rows = torch.arange(n, dtype=torch.int32, device="cuda")
        launches, past = ht.insert_table.launches, ht.insert_table.past_max_probe
        tk1, tk2, pay, occupied, longest = ht.insert_table(keys, k2, valid, m)
        if ht.insert_table.launches != launches + 1 or occupied != n:
            raise AssertionError(f"insert {what}: {ht.insert_table.launches - launches} "
                                 f"launches, {occupied} slots for {n} keys")
        hit = ht.probe_table(tk1, tk2, pay, keys, k2, max_probe=longest + 1)
        if not torch.equal(hit, rows):
            raise AssertionError(f"insert {what}: a key not found at its row")
        p_tk1, p_tk2, p_pay, p_occ, p_longest = ht.insert_table_plain(keys, k2, valid, m)
        p_hit = ht.probe_table_plain(p_tk1, p_tk2, p_pay, keys, k2, p_longest + 1)
        if p_occ != occupied or not torch.equal(p_hit, hit):
            raise AssertionError(f"insert {what}: the kernel's table differs from the "
                                 f"plain version's")
        del p_tk1, p_tk2, p_pay, p_hit, hit
        past = ht.insert_table.past_max_probe - past
        ms = cuda_ms(lambda: ht.insert_table(keys, k2, valid, m))
        plain_ms = cuda_ms(lambda: ht.insert_table_plain(keys, k2, valid, m), iters=2)

        def rounds():
            size = m
            while not ht.build_table(keys, k2, valid, size)[3]:
                size *= 2

        rounds_ms = cuda_ms(rounds, iters=2)
        nbytes = 16 * (m + 1) + 73 * n
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"kernels: [{gpu}] hashtable_insert {what}: n={n} keys, m={m} slots: kernel "
            f"{ms:.4f} ms (with the counts' host read), bound {bound_ms:.4f} ms "
            f"({nbytes / 1e9:.4f} GB at 3.35 TB/s: 16·(m + 1) + 73·n), plain "
            f"{plain_ms:.2f} ms, the capped rounds until placed {rounds_ms:.2f} ms; "
            f"occupied {occupied}, longest displacement {longest} (plain {p_longest}), "
            f"past_max_probe +{past}; every key found at its row with max_probe "
            f"{longest + 1}, the plain table's answers equal")
        out[what] = {"ms": ms, "plain_ms": plain_ms, "rounds_ms": rounds_ms,
                     "bound_ms": bound_ms, "longest": longest}
        del tk1, tk2, pay, keys, k2, valid, rows
        torch.cuda.empty_cache()
    q21 = out["q21_late_orders"]
    return {"name": "hashtable_insert", "route": "cuda",
            "source": "cudf_tpu_torch/kernels/csrc/hashtable_probe.cu",
            "replaces": "none (the reference builds with XLA scatter rounds)",
            "launches": 0, "max_abs_err": 0.0, "ms": q21["ms"], "plain_ms": q21["plain_ms"],
            "bound_ms": q21["bound_ms"], "bound_by": "bytes", "shapes": out}


# ---------------------------------------------------------------- phase 8
def sort_phase(gpu: str):
    """bench.py's sort shape at SF10 size: sort_by_key([k1, k2]) against a
    stable numpy lexsort (NaN last, as the port orders it). Returns the
    table and its sorted columns on the host."""
    import torch

    from cudf_tpu_torch import Table
    from cudf_tpu_torch.ops.sorting import sort_by_key

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    k1 = rng.integers(0, 100_000, ROWS).astype(np.float64)
    k1[rng.choice(ROWS, ROWS // 50, replace=False)] = np.nan  # ~2% NaN keys
    df = pd.DataFrame({"k1": k1, "k2": rng.normal(size=ROWS).astype(np.float32),
                       "v": rng.normal(size=ROWS).astype(np.float32)})
    order = np.lexsort((df["k2"].to_numpy(), k1))  # stable: k1, then k2
    data_s = time.perf_counter() - t0
    tbl = Table.from_pandas(df)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sort_by_key(tbl, ["k1", "k2"])
    got = {c: out[c].data[: out.num_rows].cpu().numpy() for c in ("k1", "k2", "v")}
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sort_by_key(tbl, ["k1", "k2"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for c in ("k1", "k2", "v"):
        if not np.array_equal(got[c], df[c].to_numpy()[order], equal_nan=True):
            raise AssertionError(f"sort: column {c} differs from the stable numpy lexsort")
    log(f"sort: [{gpu}] sort_by_key([k1, k2]) over {ROWS} rows (k1 f64 with "
        f"{int(np.isnan(k1).sum())} NaN, k2 f32, v f32) equals the stable numpy lexsort, "
        f"every column exact; sort+copy to host {first_s:.3f} s (first), sort warm "
        f"{warm_s * 1e3:.2f} ms (host clock); data and oracle {data_s:.1f} s")
    log(f"sort: [{gpu}] warm sort profile: "
        + device_breakdown(lambda: sort_by_key(tbl, ["k1", "k2"])))
    return tbl, got


# ---------------------------------------------------------------- phase 9
BUILDERS = {"q1": build_q1, "q3": build_q3, "q5": build_q5, "q6": build_q6}


def tpch_oracles(t) -> dict:
    """pandas answers of q1, q3, q5 and q6 (benchmarks/tpch.py's oracles,
    with q1's derived columns computed once before the groupby instead of
    per group)."""
    li = t["lineitem"]
    q1 = li[li.l_shipdate <= pd.Timestamp("1998-09-02")]
    disc_price = q1.l_extendedprice * (1 - q1.l_discount)
    q1 = q1.assign(disc_price=disc_price, charge=disc_price * (1 + q1.l_tax))
    g = q1.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"),
    ).sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)
    g["count_order"] = g["count_order"].astype("int64")
    out = {"q1": g}

    c, o = t["customer"], t["orders"]
    c3 = c[c.c_mktsegment == "BUILDING"]
    o3 = o[o.o_orderdate < pd.Timestamp("1995-03-15")]
    l3 = li[li.l_shipdate > pd.Timestamp("1995-03-15")]
    m = c3.merge(o3, left_on="c_custkey", right_on="o_custkey").merge(
        l3, left_on="o_orderkey", right_on="l_orderkey")
    m["revenue"] = m.l_extendedprice * (1 - m.l_discount)
    out["q3"] = (m.groupby(["o_orderkey", "o_shippriority"], as_index=False)
                 .agg(revenue=("revenue", "sum"))
                 .sort_values("revenue", ascending=False, kind="stable")
                 .head(10).reset_index(drop=True))

    r, n, s = t["region"], t["nation"], t["supplier"]
    r = r[r.r_name == "ASIA"]
    o5 = o[(o.o_orderdate >= pd.Timestamp("1994-01-01"))
           & (o.o_orderdate < pd.Timestamp("1995-01-01"))]
    m = (c.merge(o5, left_on="c_custkey", right_on="o_custkey")
         .merge(li, left_on="o_orderkey", right_on="l_orderkey"))
    sn = s.merge(n, left_on="s_nationkey", right_on="n_nationkey").merge(
        r, left_on="n_regionkey", right_on="r_regionkey")
    m = sn.merge(m, left_on=["s_suppkey", "s_nationkey"],
                 right_on=["l_suppkey", "c_nationkey"])
    m["revenue"] = m.l_extendedprice * (1 - m.l_discount)
    out["q5"] = (m.groupby("n_name", as_index=False).agg(revenue=("revenue", "sum"))
                 .sort_values("revenue", ascending=False, kind="stable")
                 .reset_index(drop=True))

    m = li[(li.l_shipdate >= pd.Timestamp("1994-01-01"))
           & (li.l_shipdate < pd.Timestamp("1995-01-01"))
           & (li.l_discount >= 0.05) & (li.l_discount <= 0.07) & (li.l_quantity < 24.0)]
    out["q6"] = pd.DataFrame({"revenue": [(m.l_extendedprice * m.l_discount).sum()]})
    return out


def _profile_line(profile) -> str:
    return "; ".join(f"{name} {s * 1e3:.2f} ms ({rows} rows)" for name, s, rows in profile)


def tpch_phase(gpu: str, wide_oracle):
    """TPC-H q1, q3, q5 and q6 through the IR executor at SF10
    (benchmarks/tpch.py's gen_tables(60M)), each against pandas, then the
    out-of-core phase's chunked groupby and partitioned TPC-H on the same
    tables. Returns the probe kernel's launches in the queries' first and
    warm runs, the host tables, q3's answer, the probe launches of the
    partitioned runs and their seconds, and the dense-slot kernel's
    launches in each query's first run (the main path; its counter zeroed
    before them)."""
    import torch

    from cudf_tpu_torch import Table
    from cudf_tpu_torch.expr import expressions as E
    from cudf_tpu_torch.expr import ir as IR
    from cudf_tpu_torch.kernels import dense_groupby as dg
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as oh

    t0 = time.perf_counter()
    host = gen_tables(ROWS)
    t1 = time.perf_counter()
    dev = {k: Table.from_pandas(v) for k, v in host.items()}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"tpch: [{gpu}] gen_tables({ROWS}) {t1 - t0:.1f} s, ingest of "
        + ", ".join(f"{k} {len(v)}" for k, v in host.items())
        + f" rows {t2 - t1:.1f} s (host clock)")

    def T(name):
        return IR.DataFrameScan(dev[name])

    plans = {q: build(T, E, IR, E.col) for q, build in BUILDERS.items()}
    runs = {}
    ht.probe_table.launches = 0
    oh.groupby_sum_count.launches = 0
    dg.dense_groupby.launches = 0
    dense, inserts = {}, {}
    for q, plan in plans.items():
        before, dense_before = ht.probe_table.launches, dg.dense_groupby.launches
        builds, past = ht.insert_table.launches, ht.insert_table.past_max_probe
        t0 = time.perf_counter()
        out = IR.execute(plan).to_pandas()
        first_s = time.perf_counter() - t0
        launches = ht.probe_table.launches - before
        dense[q] = dg.dense_groupby.launches - dense_before
        inserts[q] = (ht.insert_table.launches - builds,
                      ht.insert_table.past_max_probe - past)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        IR.execute(plan)
        torch.cuda.synchronize()
        runs[q] = (out, first_s, time.perf_counter() - t0, launches)
    probe_launches = ht.probe_table.launches
    for q in ("q3", "q5"):
        if runs[q][3] < 1:
            raise AssertionError(f"tpch {q}: the joins did not launch the probe kernel")
    if oh.groupby_sum_count.launches:
        raise AssertionError("tpch: the f64 groupbys launched the one-hot kernel")
    if dense["q1"] < 1 or dense["q5"] < 1:
        raise AssertionError(f"tpch: q1's and q5's groupbys launched the dense-slot kernel "
                             f"{dense['q1']} and {dense['q5']} times")
    log(f"tpch: dense-slot kernel launches in the first run: {dense}")
    log("tpch: hash builds in the first run, (insert launches, past_max_probe): "
        + ", ".join(f"{q} {v}" for q, v in inserts.items()))
    if inserts["q3"][0] < 1 or inserts["q5"][0] < 1:
        raise AssertionError("tpch: q3's and q5's joins did not build by the insert kernel")

    for q, plan in plans.items():
        out, first_s, warm_s, launches = runs[q]
        _, profile = IR.execute_with_profile(plan)
        log(f"tpch {q}: [{gpu}] {len(out)} rows; execute+to_pandas {first_s * 1e3:.2f} ms "
            f"(first), execute warm {warm_s * 1e3:.2f} ms (host clock); probe launches "
            f"{launches} in the first run")
        log(f"tpch {q}: [{gpu}] per-node profile (synchronized): " + _profile_line(profile))
        log(f"tpch {q}: [{gpu}] warm profile: "
            + device_breakdown(lambda: IR.execute(plan)))
    datetime_checks(gpu, host["lineitem"], dev["lineitem"])
    nested_joins(gpu, host, dev)
    dist_tpch(gpu, dev, plans, runs)
    wide_phase(gpu, dev, wide_oracle)
    t_ooc = time.perf_counter()
    ooc_groupby(gpu, dev["lineitem"])
    ooc_launches = ooc_tpch(gpu, plans, runs)
    ooc_s = time.perf_counter() - t_ooc
    del dev, plans
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    want = tpch_oracles(host)
    for q, exp in want.items():
        got = runs[q][0]
        pd.testing.assert_frame_equal(got[exp.columns], exp, rtol=1e-6, check_dtype=False)
    log(f"tpch: q1, q3, q5 and q6 match pandas (assert_frame_equal rtol 1e-6: keys, "
        f"counts and row order exact); pandas oracles {time.perf_counter() - t0:.1f} s "
        f"(host clock)")
    return probe_launches, host, runs["q3"][0], ooc_launches, ooc_s, dense


DT_FIELDS = ["year", "month", "day", "weekday", "day_of_year", "microsecond"]
TRUNCATE = ("M", "Y")


def datetime_checks(gpu: str, li, tbl) -> None:
    """ops/datetime.py on l_shipdate: extract and truncate against pandas'
    ``.dt`` (computed on the distinct dates and taken to every row through
    pd.factorize's codes), exactly; weekday is ISO (pandas' dayofweek + 1).
    Then one IR plan groups sum(l_extendedprice) by the ship year."""
    import torch

    from cudf_tpu_torch.expr import expressions as E
    from cudf_tpu_torch.expr import ir as IR
    from cudf_tpu_torch.ops import datetime as D

    t0 = time.perf_counter()
    ship = li["l_shipdate"].to_numpy()
    inv, uniq = pd.factorize(ship)
    s = pd.Series(np.asarray(uniq, dtype=ship.dtype)).dt
    want = {"year": s.year, "month": s.month, "day": s.day, "weekday": s.dayofweek + 1,
            "day_of_year": s.day_of_year, "microsecond": s.microsecond,
            "M": s.to_period("M").dt.start_time, "Y": s.to_period("Y").dt.start_time}
    want = {k: v.to_numpy().astype(ship.dtype if k in TRUNCATE else np.int64)[inv]
            for k, v in want.items()}
    oracle_s = time.perf_counter() - t0
    col = tbl["l_shipdate"]
    n = col.length
    times = {}
    for field in DT_FIELDS + list(TRUNCATE):
        def op(field=field):
            return D.truncate(col, field) if field in TRUNCATE else D.extract(col, field)
        out = op()
        torch.cuda.synchronize()
        got = out.data[:n].cpu().numpy()
        if field in TRUNCATE:
            got = got.view(ship.dtype)
        if not np.array_equal(got, want[field]):
            raise AssertionError(f"datetime: {field} differs from pandas")
        times[field] = cuda_ms(op, iters=5)
    log(f"datetime: [{gpu}] extract {'/'.join(DT_FIELDS)} and truncate M/Y of "
        f"l_shipdate ({n} rows, {ship.dtype}, {len(uniq)} distinct dates) equal pandas "
        f".dt exactly; device ms a call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; pandas oracles {oracle_s:.1f} s (host clock)")

    plan = IR.Sort(("year",), (False,), (True,), children=(
        IR.GroupBy(("year",), (E.NamedExpr("revenue", E.col("l_extendedprice").sum()),),
                   children=(IR.HStack((E.NamedExpr("year", E.col("l_shipdate").dt.year()),),
                                       children=(IR.DataFrameScan(tbl),)),)),))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = IR.execute(plan).to_pandas()
    plan_s = time.perf_counter() - t0
    exp = li.groupby(li["l_shipdate"].dt.year.rename("year"))["l_extendedprice"].sum()
    np.testing.assert_array_equal(got["year"].to_numpy(np.int64), exp.index.to_numpy(np.int64))
    np.testing.assert_allclose(got["revenue"].to_numpy(), exp.to_numpy(), rtol=1e-6)
    log(f"datetime: [{gpu}] sum(l_extendedprice) by col('l_shipdate').dt.year() through "
        f"IR.execute: {len(got)} years, equal to pandas (years exact, sums rtol 1e-6); "
        f"execute+to_pandas {plan_s * 1e3:.2f} ms (host clock)")


# --------------------------------------------------------------- phase 10
STR_ROWS = 16_000_000        # bench_sizes.py's middle size; 8M distinct strings
BENCH_REGEX = r"url/0{3}[0-9a-f]{6}/page"   # bench.py's regex_hc
SELECTIVE_REGEX = r"[0-9a-f]{8}7/page"      # about 1 key in 16
EXTRACT = r"^url/([0-9a-f]+)/page$"


def synced(fn):
    """(fn(), seconds) on the host clock, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peaked(fn):
    """(fn(), seconds, peak bytes): the host clock as ``synced`` reads it,
    and the peak of torch.cuda.max_memory_allocated above the allocation
    before the call (what fn allocated at most at once, its output
    included)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, s = synced(fn)
    return out, s, torch.cuda.max_memory_allocated() - start


def check_peaks(what: str, chunked_peak: int, unchunked_peak: int, nbytes: int) -> str:
    """The chunked branch exists to hold less on the card: its peak must be
    below the unchunked op's. Returns the line's text for both."""
    text = (f"peak allocation chunked {chunked_peak} bytes ({chunked_peak / nbytes:.3f} of the "
            f"input's {nbytes}), unchunked {unchunked_peak} bytes "
            f"({unchunked_peak / nbytes:.3f}), ratio {chunked_peak / unchunked_peak:.3f}")
    if chunked_peak >= unchunked_peak:
        raise AssertionError(f"{what}: the chunked branch's {text}: not lower")
    return text


def strings_phase(gpu: str) -> None:
    """bench.py's high-cardinality strings (regex_hc, tokens_hc and their
    neighbours) at STR_ROWS rows drawn from a pool of STR_ROWS/2 keys: each
    op against an oracle computed on the pool with Python re or numpy and
    taken to every row through the generator's indices, exactly. The regexes
    and the extract must take the device lanes."""
    import re

    from cudf_tpu_torch import Table
    from cudf_tpu_torch.ops import strings as S
    from cudf_tpu_torch.ops import text as X

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pool = np.array([f"url/{i:09x}/page" for i in range(STR_ROWS // 2)])
    idx = rng.integers(0, len(pool), STR_ROWS)
    df = pd.DataFrame({"k": pool[idx]})
    data_s = time.perf_counter() - t0
    tbl, ingest_s = synced(lambda: Table.from_pandas(df))
    k = tbl["k"]
    log(f"strings: [{gpu}] {STR_ROWS} rows from a pool of {len(pool)} keys: data "
        f"{data_s:.1f} s, Table.from_pandas {ingest_s:.1f} s (host clock); dictionary "
        f"{len(k.dictionary)} values")

    def search(pat, how):
        rx = re.compile(pat)
        probe = rx.search if how == "search" else rx.match
        return np.fromiter((probe(s) is not None for s in pool), bool, len(pool))

    t0 = time.perf_counter()
    hexes = np.array([m.group(1) for m in map(re.compile(EXTRACT).match, pool)])
    oracles = {"contains_bench": search(BENCH_REGEX, "search"),
               "contains_selective": search(SELECTIVE_REGEX, "search"),
               "startswith": np.char.startswith(pool, "url/00"),
               "count_tokens": np.char.count(pool, "/").astype(np.int32) + 1,
               "len_strings": np.char.str_len(pool).astype(np.int32)}
    oracle_s = time.perf_counter() - t0
    ops = {"contains_bench": (lambda: S.contains(k, BENCH_REGEX, regex=True), S._dfa_steps),
           "contains_selective": (lambda: S.contains(k, SELECTIVE_REGEX, regex=True),
                                  S._dfa_steps),
           "startswith": (lambda: S.startswith(k, "url/00"), None),
           "count_tokens": (lambda: X.count_tokens(k, "/"), X._count_tokens_device),
           "len_strings": (lambda: S.len_strings(k), None),
           "extract_re": (lambda: S.extract_re(k, EXTRACT), S._classrun_kernel)}
    for lane in (S._dfa_steps, S._classrun_kernel, X._count_tokens_device):
        lane.launches = 0
    for name, (fn, lane) in ops.items():
        before = lane.launches if lane is not None else 0
        out, first_s = synced(fn)
        _, warm_s = synced(fn)
        if lane is not None and lane.launches - before != 2:
            raise AssertionError(f"strings {name}: the device lane did not run")
        n = out.length
        if out.validity is not None and not bool(out.validity[:n].all()):
            raise AssertionError(f"strings {name}: null rows")
        got = out.data[:n].cpu().numpy()
        if name == "extract_re":
            # the rows' captures as codes into the output's dictionary
            pos = np.minimum(np.searchsorted(out.dictionary, hexes), len(out.dictionary) - 1)
            if not (out.dictionary[pos] == hexes)[idx].all():
                raise AssertionError("strings extract_re: a row's capture is not in the "
                                     "output's dictionary")
            want = pos.astype(np.int32)[idx]
        else:
            want = oracles[name][idx]
        if not np.array_equal(got, want):
            raise AssertionError(f"strings {name}: rows differ from the pool oracle")
        hits = int(want.sum()) if want.dtype == bool else len(np.unique(want))
        log(f"strings {name}: [{gpu}] {n} rows equal the oracle "
            f"({'rows matching' if want.dtype == bool else 'distinct answers'} {hits}); "
            f"first {first_s * 1e3:.2f} ms, warm {warm_s * 1e3:.2f} ms (host clock, "
            f"synchronized); lane "
            + ("host" if lane is None else f"{lane.__name__} x{lane.launches - before}"))
    log(f"strings: lane launches in the phase: _dfa_steps {S._dfa_steps.launches}, "
        f"_classrun_kernel {S._classrun_kernel.launches}, _count_tokens_device "
        f"{X._count_tokens_device.launches}; pool oracles {oracle_s:.1f} s (host clock)")
    log(f"strings: [{gpu}] warm contains (bench pattern) profile: "
        + device_breakdown(ops["contains_bench"][0]))
    nested_strings(gpu, k, pool, idx)


# --------------------------------------------------------------- phase 11
SCAN_ROWS = ROWS             # bench.py's scan_parquet shape at SF10 lineitem size
Q3_COLUMNS = {"lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
              "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
              "customer": ["c_custkey", "c_mktsegment"]}


def io_phase(gpu: str, host, q3_in_memory, tmp: str):
    """Parquet files written by pyarrow into ``tmp`` (outside every timed
    region): bench.py's scan (read_parquet(path)["v"] and a device sum, the
    other columns never decoded), the frame phase's scan (frame_scan), TPC-H
    q3 through IR.Scan against the in-memory q3 exactly, and q3's result
    through IR.Sink and back. Returns the probe kernel's launches in q3's
    first run from parquet and the frame scan's seconds."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from cudf_tpu_torch.io import read_parquet
    from cudf_tpu_torch.expr import expressions as E
    from cudf_tpu_torch.expr import ir as IR
    from cudf_tpu_torch.kernels import hashtable as ht

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    v = rng.normal(size=SCAN_ROWS).astype(np.float32)
    k = rng.integers(0, SCAN_ROWS // 20, SCAN_ROWS)
    scan_path = os.path.join(tmp, "scan.parquet")
    pq.write_table(pa.table({"k": k, "v": v,
                             "w": rng.normal(size=SCAN_ROWS).astype(np.float32)}),
                   scan_path)
    paths = {}
    for name, cols in Q3_COLUMNS.items():
        paths[name] = os.path.join(tmp, f"{name}.parquet")
        pq.write_table(pa.Table.from_pandas(host[name][cols], preserve_index=False),
                       paths[name])
    log(f"io: [{gpu}] wrote {SCAN_ROWS} scan rows and q3's tables to parquet in "
        f"{time.perf_counter() - t0:.1f} s (host clock, outside the timed regions)")

    def scan():
        t = read_parquet(scan_path)
        col = t["v"]
        return t, col, col.data[: col.length].sum()

    times = []
    for _ in range(2):
        (t, col, total), s = synced(scan)
        times.append(s)
        if t.undecoded() != ["k", "w"]:
            raise AssertionError(f"io scan: decoded {t.names} less {t.undecoded()}")
    if not np.array_equal(col.data[: col.length].cpu().numpy(), v):
        raise AssertionError("io scan: v differs from the written array")
    want_sum = float(v.sum(dtype=np.float64))
    if abs(float(total) - want_sum) > 1e-4 * float(np.abs(v).sum()):
        raise AssertionError(f"io scan: device sum {float(total)}, numpy {want_sum}")
    size_mb = os.path.getsize(scan_path) / 1e6
    log(f"io scan: [{gpu}] read_parquet(path)['v'] + device sum over {SCAN_ROWS} rows "
        f"({size_mb:.1f} MB file): first {times[0] * 1e3:.2f} ms, warm "
        f"{times[1] * 1e3:.2f} ms (host clock, synchronized); v equals the written "
        f"array exactly, k and w never decoded")
    _, decode_s = synced(lambda: pq.ParquetFile(scan_path).read(columns=["v"]).column(0))
    _, copy_s = synced(lambda: torch.from_numpy(v).to(col.device))
    log(f"io scan: [{gpu}] its parts: pyarrow decode of v {decode_s * 1e3:.2f} ms, "
        f"host-to-device copy of v {copy_s * 1e3:.2f} ms (host clock, synchronized)")
    frame_s = frame_scan(gpu, scan_path, k, v)
    nested_s3(gpu, scan_path, v)

    plan = build_q3(lambda n: IR.Scan("parquet", (paths[n],)), E, IR, E.col)
    def first_run():
        out = IR.execute(plan)
        return out, out.to_pandas()

    ht.probe_table.launches = 0
    (result, got), first_s = synced(first_run)
    launches = ht.probe_table.launches
    if launches != 2:
        raise AssertionError(f"io q3: the probe kernel launched {launches} times, not 2")
    pd.testing.assert_frame_equal(got, q3_in_memory)
    # the second run, profiled: each run reads its files again, and a column's
    # decode and copy fall in the first node that uses it
    _, profile = IR.execute_with_profile(plan)
    log(f"io q3: [{gpu}] q3 through IR.Scan('parquet') equals the in-memory q3 exactly "
        f"({len(got)} rows); execute+to_pandas {first_s * 1e3:.2f} ms (first run), "
        f"{sum(s for _, s, _ in profile) * 1e3:.2f} ms (second run, profiled) (host "
        f"clock); probe launches {launches} in the first run")
    log(f"io q3: [{gpu}] per-node profile (synchronized): " + _profile_line(profile))

    out_path = os.path.join(tmp, "q3_result.parquet")
    sink = IR.Sink("parquet", out_path, children=(IR.DataFrameScan(result),))
    _, sink_s = synced(lambda: IR.execute(sink))
    back = read_parquet(out_path).to_pandas()
    pd.testing.assert_frame_equal(back, q3_in_memory)
    log(f"io sink: [{gpu}] q3's result through IR.Sink('parquet') {sink_s * 1e3:.2f} ms "
        f"(host clock), read back equal ({len(back)} rows)")
    nested_avro(gpu, host, tmp)
    return launches, frame_s


# --------------------------------------------------------------- phase 13
# The out-of-core phase runs beside the phases whose data it reuses: the
# streamed README groupby and the chunked compaction on phase 3's frame and
# table, the partitioned Q3 join on phase 5's tables, the out-of-core and
# chunked sorts on phase 8's table, the chunked groupby and the partitioned
# TPC-H on phase 9's. Its budgets are below the data they govern, so
# partitions spill to the host and come back, and the chunked ops chunk.
OOC_ROW_GROUP = 1 << 20      # rows in a parquet row group and a partition
OOC_JOIN_PARTS = 16          # partitions of the 60M lineitem rows (Q3 join)
OOC_SORT_PARTS = 32          # partitions of bench.py's sort table
# the partitioned TPC-H: 1 GiB partitions split SF10 lineitem (3.84 GB by
# the lowering's estimate) into 4; orders (0.48 GB) is broadcast, lineitem
# shuffled
OOC_TPCH_CONFIG = (1 << 30, 1 << 30)


def ooc_setup(budget_bytes: int, store_dir=None):
    """Install an HbmBudget of ``budget_bytes`` and, with ``store_dir``, a
    native PartitionStore of as many host bytes spilling to files there.
    Returns (budget, store); ``ooc_teardown`` removes both."""
    from cudf_tpu_torch.parallel import partitioned as P
    from cudf_tpu_torch.utils.hbm import HbmBudget, set_hbm_budget
    from cudf_tpu_torch.utils.native import PartitionStore

    budget = HbmBudget(budget_bytes)
    set_hbm_budget(budget)
    store = None
    if store_dir is not None:
        store = PartitionStore(budget_bytes=budget_bytes, spill_dir=store_dir)
        P.set_partition_store(store)
    for key in P.transfers:
        P.transfers[key] = 0
    return budget, store


def ooc_teardown(store) -> None:
    from cudf_tpu_torch.parallel import partitioned as P
    from cudf_tpu_torch.utils.hbm import set_hbm_budget

    set_hbm_budget(None)
    P.set_partition_store(None)
    if store is not None:
        store.close()


def _transfers_line() -> str:
    from cudf_tpu_torch.parallel.partitioned import transfers as t

    return (f"spill copies to the host {t['to_host_bytes'] / 1e9:.3f} GB in "
            f"{t['to_host_s']:.3f} s, un-spill copies to the card "
            f"{t['to_device_bytes'] / 1e9:.3f} GB in {t['to_device_s']:.3f} s (synchronous, "
            f"pageable)")


def ooc_readme(gpu: str, df, tbl, in_memory, tmp: str):
    """E.1: phase 3's columns written to parquet in 1M-row row groups, read
    back through PartitionedFrame.read_parquet_chunked under a budget of a
    quarter of their bytes on the card, with the native store installed,
    and the README query run on them: map_partitions(drop_nulls) then
    groupby_agg. Groups and counts equal phase 3's answer exactly, sums
    and means rtol 1e-5 (f32 partial sums, the port's groupby tolerance).
    Returns the one-hot launches, the budget's bytes and the seconds."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from cudf_tpu_torch import AggSpec, drop_nulls
    from cudf_tpu_torch.kernels import onehot_groupby as k
    from cudf_tpu_torch.parallel.partitioned import PartitionedFrame
    from cudf_tpu_torch.utils.hbm import table_device_bytes

    t_start = time.perf_counter()
    cols = KEYS + ["l_extendedprice"]
    path = os.path.join(tmp, "readme.parquet")
    pq.write_table(pa.Table.from_pandas(df[cols], preserve_index=False), path,
                   row_group_size=OOC_ROW_GROUP)
    write_s = time.perf_counter() - t_start
    aggs = [AggSpec("l_extendedprice", "sum", "sum_price"),
            AggSpec("l_extendedprice", "mean", "avg_price"),
            AggSpec("l_extendedprice", "count", "count_price"),
            AggSpec("", "size", "count_order")]
    in_memory_bytes = table_device_bytes(tbl.select(cols))
    budget, store = ooc_setup(in_memory_bytes // 4, os.path.join(tmp, "spill"))
    try:
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k.groupby_sum_count.launches = 0
        t0 = time.perf_counter()
        pf = PartitionedFrame.read_parquet_chunked(path, rows_per_chunk=OOC_ROW_GROUP)
        t1 = time.perf_counter()
        out = pf.map_partitions(drop_nulls).groupby_agg(KEYS, aggs).to_pandas()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - start
        launches = k.groupby_sum_count.launches
        stats, store_stats, moved = budget.stats(), store.stats(), _transfers_line()
        n_parts = pf.npartitions
        del pf
    finally:
        ooc_teardown(store)
    log(f"ooc readme: [{gpu}] {len(df)} rows of {cols} written to parquet in "
        f"{OOC_ROW_GROUP}-row row groups in {write_s:.1f} s; read_parquet_chunked -> "
        f"{n_parts} spilled partitions {t1 - t0:.3f} s, map_partitions(drop_nulls) + "
        f"groupby_agg + to_pandas {t2 - t1:.3f} s (host clock, synchronized); one-hot "
        f"kernel launches {launches}")
    log(f"ooc readme: [{gpu}] budget {stats['budget']} bytes (a quarter of the columns' "
        f"{in_memory_bytes} bytes in memory): spill_count {stats['spill_count']}, "
        f"spilled_bytes {stats['spilled_bytes']}, admitted {stats['admitted']}; native "
        f"store {store_stats}; {moved}")
    log(f"ooc readme: [{gpu}] peak device allocation above the phase's start {peak} bytes "
        f"({peak / in_memory_bytes:.3f} of the columns' {in_memory_bytes} bytes in memory)")
    if stats["spill_count"] <= 0:
        raise AssertionError("ooc readme: no partition was spilled")
    if launches < n_parts:
        raise AssertionError(f"ooc readme: {launches} one-hot launches for {n_parts} "
                             f"partitions")
    if peak >= in_memory_bytes:
        raise AssertionError(f"ooc readme: peak {peak} bytes is not below the in-memory "
                             f"{in_memory_bytes}")
    np.testing.assert_array_equal(out[KEYS].to_numpy(np.int64),
                                  in_memory[KEYS].to_numpy(np.int64))
    for c in ("count_price", "count_order"):
        np.testing.assert_array_equal(out[c].to_numpy(), in_memory[c].to_numpy())
    for c in ("sum_price", "avg_price"):
        np.testing.assert_allclose(out[c], in_memory[c], rtol=1e-5)
    log(f"ooc readme: equals phase 3's in-memory answer: {len(out)} groups, keys and "
        f"counts exact, sum and mean rtol 1e-5")
    return launches, in_memory_bytes // 4, time.perf_counter() - t_start


def ooc_compaction(gpu: str, tbl) -> float:
    """E.4: drop_nulls of phase 3's table under a budget of half its bytes
    (its working set is twice them): the chunked branch, rows exactly the
    unchunked drop_nulls', its peak allocation below the unchunked one's."""
    import torch

    from cudf_tpu_torch import drop_nulls
    from cudf_tpu_torch.ops import chunked
    from cudf_tpu_torch.utils.hbm import table_device_bytes

    t_start = time.perf_counter()
    want, want_s, want_peak = peaked(lambda: drop_nulls(tbl))
    nbytes = table_device_bytes(tbl)
    runs = chunked.runs["compaction"]
    _, store = ooc_setup(nbytes // 2)
    try:
        got, s, peak = peaked(lambda: drop_nulls(tbl))
        rows = chunked.chunk_rows(tbl, chunked.COMPACT_FACTOR)
    finally:
        ooc_teardown(store)
    if chunked.runs["compaction"] != runs + 1:
        raise AssertionError("ooc compaction: drop_nulls did not take the chunked branch")
    n = want.num_rows
    if got.num_rows != n:
        raise AssertionError(f"ooc compaction: {got.num_rows} rows, unchunked {n}")
    for name, c in want:
        g = got[name]
        if not torch.equal(g.data[:n], c.data[:n]) or \
                (c.validity is None) != (g.validity is None) or \
                (c.validity is not None and not torch.equal(g.validity[:n], c.validity[:n])):
            raise AssertionError(f"ooc compaction: column {name} differs from unchunked")
    log(f"ooc compaction: [{gpu}] drop_nulls of {tbl.num_rows} rows under a budget of "
        f"{nbytes // 2} bytes: chunked ({rows}-row chunks) in {s * 1e3:.2f} ms, unchunked "
        f"{want_s * 1e3:.2f} ms (host clock, synchronized), {n} rows equal to the unchunked "
        f"drop_nulls exactly; {check_peaks('ooc compaction', peak, want_peak, nbytes)}")
    # what every sort, groupby and compaction now pays to decide, with no
    # budget installed, and what asking the card would cost each of them
    check_us = host_us(lambda: chunked.chunk_rows(tbl, chunked.COMPACT_FACTOR))
    query_us = host_us(lambda: torch.cuda.mem_get_info(), iters=200)
    log(f"ooc compaction: [{gpu}] the chunk check with no budget installed: "
        f"{check_us:.2f} us a call on the host (unchunked: "
        f"{chunked.chunk_rows(tbl, chunked.COMPACT_FACTOR) is None}); "
        f"torch.cuda.mem_get_info, which it skips below an eighth of the card: "
        f"{query_us:.2f} us a call")
    return time.perf_counter() - t_start


def ooc_join(gpu: str, li, filtered, want, budget_bytes: int):
    """E.2: lineitem's [l_orderkey, l_extendedprice] in OOC_JOIN_PARTS
    spilled partitions under E.1's budget, join_small with the filtered
    orders: the oracle's rows as a multiset, one probe launch a partition.
    Returns the probe launches and the seconds."""
    import torch

    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.parallel.partitioned import PartitionedFrame

    t_start = time.perf_counter()
    n = li.num_rows
    step = -(-n // OOC_JOIN_PARTS)
    budget, store = ooc_setup(budget_bytes)
    try:
        t0 = time.perf_counter()
        pf = PartitionedFrame.from_tables(li.slice(s, step) for s in range(0, n, step))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ht.probe_table.launches = 0
        out = pf.join_small(filtered, ["l_orderkey"], ["o_orderkey"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = ht.probe_table.launches
        got = {c: [] for c in JOIN_COLS}
        for p in out._parts:
            for c, v in _columns(p.get(), JOIN_COLS).items():
                got[c].append(v)
        stats, moved = budget.stats(), _transfers_line()
        n_parts = pf.npartitions
        del pf, out
    finally:
        ooc_teardown(store)
    got = {c: np.concatenate(v) for c, v in got.items()}
    log(f"ooc join: [{gpu}] {n} lineitem rows in {n_parts} spilled partitions "
        f"{t1 - t0:.3f} s; join_small with {filtered.num_rows} filtered orders -> "
        f"{len(got['l_orderkey'])} rows, spilled, {t2 - t1:.3f} s (host clock, "
        f"synchronized); probe launches {launches}; budget {budget_bytes} bytes: "
        f"spill_count {stats['spill_count']}, spilled_bytes {stats['spilled_bytes']}; "
        f"{moved}")
    if launches != n_parts:
        raise AssertionError(f"ooc join: {launches} probe launches for {n_parts} partitions")
    if stats["spill_count"] <= 0:
        raise AssertionError("ooc join: no partition was spilled")
    assert_rows(got, want, "ooc join", True)
    log(f"ooc join: equals the oracle as a multiset ({len(got['l_orderkey'])} rows, every "
        f"column exact)")
    return launches, time.perf_counter() - t_start


def _sorted_host(tbl, cols=("k1", "k2", "v")) -> dict:
    return {c: tbl[c].data[: tbl.num_rows].cpu().numpy() for c in cols}


def _frame_host(pf, cols=("k1", "k2", "v")) -> dict:
    parts = [_sorted_host(p.get(), cols) for p in pf._parts]
    return {c: np.concatenate([p[c] for p in parts]) for c in cols}


def _assert_sorted_equal(got: dict, want: dict, what: str) -> None:
    for c in want:
        if len(got[c]) != len(want[c]):
            raise AssertionError(f"{what}: {len(got[c])} rows, in memory {len(want[c])}")
        if not np.array_equal(got[c], want[c], equal_nan=True):
            raise AssertionError(f"{what}: column {c} differs from the in-memory sort")


def ooc_sort(gpu: str, tbl, ascending: dict) -> float:
    """E.3 and E.4 on bench.py's sort table: PartitionedFrame.sort_values
    over OOC_SORT_PARTS spilled partitions under a budget of a quarter of
    the table's bytes, ascending and descending, each equal to the
    in-memory sort_by_key exactly with every row kept; then sort_by_key
    under a budget of that quarter (below its working set of four times
    the table): the chunked branch, equal exactly, its peak allocation
    below the unchunked sort's."""
    import torch

    from cudf_tpu_torch.ops import chunked
    from cudf_tpu_torch.ops.sorting import sort_by_key
    from cudf_tpu_torch.parallel.partitioned import PartitionedFrame
    from cudf_tpu_torch.utils.hbm import set_hbm_budget, table_device_bytes

    t_start = time.perf_counter()
    keys = ["k1", "k2"]
    descending = _sorted_host(sort_by_key(tbl, keys, descending=True))
    nbytes = table_device_bytes(tbl)
    n = tbl.num_rows
    step = -(-n // OOC_SORT_PARTS)
    budget, store = ooc_setup(nbytes // 4)
    try:
        pf = PartitionedFrame.from_tables(tbl.slice(s, step) for s in range(0, n, step))
        times = {}
        for name, desc, want in (("ascending", False, ascending),
                                 ("descending", True, descending)):
            out, times[name] = synced(lambda: pf.sort_values(keys, desc))
            _assert_sorted_equal(_frame_host(out), want, f"ooc sort {name}")
            times[name + " partitions"] = out.npartitions
            del out
        stats, moved = budget.stats(), _transfers_line()
        del pf
        set_hbm_budget(None)
        unchunked, unchunked_s, unchunked_peak = peaked(lambda: sort_by_key(tbl, keys))
        del unchunked
        set_hbm_budget(budget)
        runs = chunked.runs["sort"]
        got, chunked_s, chunked_peak = peaked(lambda: sort_by_key(tbl, keys))
        rows = chunked.chunk_rows(tbl, chunked.SORT_FACTOR)
    finally:
        ooc_teardown(store)
    log(f"ooc sort: [{gpu}] PartitionedFrame.sort_values([k1, k2]) over {n} rows in "
        f"{OOC_SORT_PARTS} spilled partitions, budget {nbytes // 4} bytes (a quarter of "
        f"the table's {nbytes}): ascending {times['ascending']:.3f} s -> "
        f"{times['ascending partitions']} partitions, descending {times['descending']:.3f} s "
        f"-> {times['descending partitions']} partitions (host clock, synchronized); each "
        f"equals the in-memory sort_by_key exactly, all {n} rows kept; spill_count "
        f"{stats['spill_count']}, spilled_bytes {stats['spilled_bytes']}; {moved}")
    if stats["spill_count"] <= 0:
        raise AssertionError("ooc sort: no partition was spilled")
    if chunked.runs["sort"] != runs + 1:
        raise AssertionError("ooc sort: sort_by_key did not take the chunked branch")
    _assert_sorted_equal(_sorted_host(got), ascending, "chunked sort")
    log(f"ooc sort: [{gpu}] sort_by_key([k1, k2]) under a budget of {nbytes // 4} bytes: "
        f"chunked ({rows}-row chunks) in {chunked_s * 1e3:.2f} ms, unchunked "
        f"{unchunked_s * 1e3:.2f} ms (host clock, synchronized), equal to the in-memory "
        f"sort exactly; {check_peaks('chunked sort', chunked_peak, unchunked_peak, nbytes)}")
    return time.perf_counter() - t_start


Q1_SHAPE_AGGS = [("l_quantity", "sum", "sum_qty"), ("l_extendedprice", "sum", "sum_price"),
                 ("l_quantity", "mean", "avg_qty"), ("l_extendedprice", "mean", "avg_price"),
                 ("l_discount", "mean", "avg_disc"), ("", "size", "count_order")]


def ooc_groupby(gpu: str, lineitem) -> None:
    """E.4: groupby_aggregate in q1's shape (l_returnflag, l_linestatus;
    sums and means of f64 columns, size) on SF10 lineitem under a budget of
    a fifth of its working set: the chunked branch, groups and counts equal
    to the unchunked groupby exactly, f64 aggregates rtol 1e-9 (the port's
    groupby tests' f64 tolerance), its peak allocation below the unchunked
    groupby's. The dense-slot lane is switched off: it holds no working
    set, so it takes this groupby whole under any budget; the chunks bound
    the sort lane's."""
    from cudf_tpu_torch import AggSpec, groupby_aggregate
    from cudf_tpu_torch.ops import chunked, densegroup
    from cudf_tpu_torch.utils.hbm import table_device_bytes

    aggs = [AggSpec(*a) for a in Q1_SHAPE_AGGS]
    keys = ["l_returnflag", "l_linestatus"]
    used = lineitem.select(keys + ["l_quantity", "l_extendedprice", "l_discount"])
    dense = densegroup.dense_groupby
    densegroup.dense_groupby = lambda *a, **k: None
    try:
        want, want_s, want_peak = peaked(lambda: groupby_aggregate(lineitem, keys, aggs))
        want = want.to_pandas()
        limit = table_device_bytes(used) * chunked.GROUPBY_FACTOR // 5
        runs = chunked.runs["groupby"]
        _, store = ooc_setup(limit)
        try:
            out, s, peak = peaked(lambda: groupby_aggregate(lineitem, keys, aggs))
            rows = chunked.chunk_rows(used, chunked.GROUPBY_FACTOR)
        finally:
            ooc_teardown(store)
    finally:
        densegroup.dense_groupby = dense
    if chunked.runs["groupby"] != runs + 1:
        raise AssertionError("ooc groupby: q1's groupby did not take the chunked branch")
    got = out.to_pandas()
    pd.testing.assert_frame_equal(got[keys + ["count_order"]], want[keys + ["count_order"]])
    pd.testing.assert_frame_equal(got, want, rtol=1e-9)
    log(f"ooc groupby: [{gpu}] groupby_aggregate in q1's shape over {lineitem.num_rows} "
        f"lineitem rows under a budget of {limit} bytes: chunked ({rows}-row chunks) in "
        f"{s * 1e3:.2f} ms, unchunked {want_s * 1e3:.2f} ms (host clock, synchronized); "
        f"{len(got)} groups, keys and counts equal to the unchunked groupby exactly, f64 "
        f"aggregates rtol 1e-9; "
        f"{check_peaks('ooc groupby', peak, want_peak, table_device_bytes(used))}")


def _plan_counts(lowered, info) -> str:
    from cudf_tpu_torch.expr.nodebase import traversal

    shown = ("DataFrameScan", "Shuffle", "Repartition", "Join", "GroupBy", "Sort")
    return ", ".join(f"{type(n).__name__}{list(n.args[0]) if type(n).__name__ == 'Shuffle' else ''}"
                     f"x{info[n].count}" for n in traversal(lowered)
                     if type(n).__name__ in shown)


def ooc_tpch(gpu: str, plans: dict, runs: dict) -> int:
    """E.5: q1, q3, q5 and q6 through execute_partitioned (no budget, the
    partitions on the card) with OOC_TPCH_CONFIG, which must split lineitem
    into at least 4 partitions and give q3 and q5 a broadcast and a shuffle
    join; each answer equal to phase 9's IR.execute answer (row order
    exact where the plan sorts, keys and counts exact, f64 rtol 1e-9), the
    probe kernel launched at least once for each partition of a join.
    Returns the probe launches."""
    from cudf_tpu_torch.expr.lowering import LoweringConfig, lower_ir_graph
    from cudf_tpu_torch.expr.nodebase import traversal
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.parallel.plan_executor import execute_partitioned

    cfg = LoweringConfig(*OOC_TPCH_CONFIG)
    total = 0
    for q, plan in plans.items():
        lowered, info = lower_ir_graph(plan, cfg)
        nodes = list(traversal(lowered))
        scans = [info[n].count for n in nodes if type(n).__name__ == "DataFrameScan"
                 and n._tbl.num_rows == ROWS]
        if not scans or min(scans) < 4:
            raise AssertionError(f"ooc tpch {q}: lineitem in {scans} partitions, not >= 4")
        joins = [n for n in nodes if type(n).__name__ == "Join"]
        kinds = {all(type(c).__name__ == "Shuffle" for c in j.children) for j in joins}
        if q in ("q3", "q5") and kinds != {True, False}:
            raise AssertionError(f"ooc tpch {q}: not both a broadcast and a shuffle join")
        before = ht.probe_table.launches
        got, first_s = synced(lambda: execute_partitioned(plan, cfg).to_pandas())
        launches = ht.probe_table.launches - before
        _, warm_s = synced(lambda: execute_partitioned(plan, cfg))
        total += ht.probe_table.launches - before
        join_parts = sum(info[j].count for j in joins)
        if launches < join_parts:
            raise AssertionError(f"ooc tpch {q}: {launches} probe launches for "
                                 f"{join_parts} join partitions")
        pd.testing.assert_frame_equal(got, runs[q][0], rtol=1e-9)
        log(f"ooc tpch {q}: [{gpu}] execute_partitioned {len(got)} rows, equal to "
            f"IR.execute's (rtol 1e-9, order and counts exact); first {first_s * 1e3:.2f} ms "
            f"with to_pandas, warm {warm_s * 1e3:.2f} ms against IR.execute's warm "
            f"{runs[q][2] * 1e3:.2f} ms (host clock, synchronized); probe launches "
            f"{launches} in the first run for {join_parts} join partitions")
        log(f"ooc tpch {q}: lowered plan: {_plan_counts(lowered, info)}")
    return total


# --------------------------------------------------------------- phase 14
# The nested and long-tail phase runs beside the phases whose data it
# reuses: the intervals, sketches, hashes and pack on phase 3's 60M
# lineitem rows, COLLECT_LIST on phase 4's first CUT_ROWS, the bloom filter
# on phase 5's Q3 join, the joins with a predicate on phase 9's SF10
# tables, the lists on phase 10's strings, and avro and S3 in phase 11's
# directory. NESTED sums its seconds and the kernels' launches.
NESTED = {"seconds": 0.0, "onehot_launches": 0, "probe_launches": 0}
NEST_HASH_ROWS = CUT_ROWS    # rows hashed with md5, sha256 and xxhash_64
NEST_HASH_SLICE = 1_000_000  # rows hashed with all eight algorithms
NEST_HASH_SAMPLE = 200_000   # of them held to hashlib and to the CPU path
NEST_COND_ROWS = 1_000_000   # lineitem rows of the conditional join (x 1000 bands)
NEST_BANDS = 1000
NEST_AVRO_ROWS = 1_000_000   # rows written to and read from avro
BLOOM_LOG2, BLOOM_K = 27, 3
QUANTILES = (0.01, 0.25, 0.5, 0.75, 0.99)


def _nested_done(t0: float) -> None:
    NESTED["seconds"] += time.perf_counter() - t0


def _host(col):
    """A column's logical rows on the host, as its physical values."""
    return col.data[: col.length].cpu().numpy()


def _valid(col):
    """A column's host validity (all True without a mask)."""
    if col.validity is None:
        return np.ones(col.length, bool)
    return col.validity[: col.length].cpu().numpy()


def nested_intervals(gpu: str, tbl, df) -> None:
    """Step 3: cut(l_extendedprice, 16) and qcut(..., 10) at 60M rows equal
    to pandas.cut/qcut, then groupby(bin).agg(mean, size) through the Table
    API and the frame against numpy, the one-hot kernel counted."""
    import torch

    from cudf_tpu_torch import AggSpec, DataFrame, Series, Table, groupby_aggregate
    from cudf_tpu_torch.core.interval import cut, qcut
    from cudf_tpu_torch.kernels import onehot_groupby as oh

    t0 = time.perf_counter()
    price = tbl["l_extendedprice"]
    host_p = df["l_extendedprice"].to_numpy()
    n = price.length
    bins, cut_s = synced(lambda: cut(price, 16))
    _, cut_warm = synced(lambda: cut(price, 16))
    deciles, qcut_s = synced(lambda: qcut(price, 10))
    t1 = time.perf_counter()
    want_cut = pd.cut(host_p, 16).codes
    want_q = pd.qcut(host_p, 10).codes
    oracle_s = time.perf_counter() - t1
    for name, got, want in (("cut", bins, want_cut), ("qcut", deciles, want_q)):
        codes = np.where(_valid(got), _host(got), -1)
        if not np.array_equal(codes, want):
            raise AssertionError(f"nested {name}: codes differ from pandas in "
                                 f"{int((codes != want).sum())} rows")
    oh.groupby_sum_count.launches = 0
    g = Table({"bin": bins, "p": price})
    aggs = [AggSpec("p", "mean", "mean"), AggSpec("", "size", "size")]
    out, gb_s = synced(lambda: groupby_aggregate(g, ["bin"], aggs))
    frame = DataFrame({"bin": Series(column=bins), "p": Series(column=price)})
    fout, frame_s = synced(lambda: frame.groupby("bin").agg(mean=("p", "mean"),
                                                             size=("p", "size")))
    launches = oh.groupby_sum_count.launches
    if launches < 2:
        raise AssertionError(f"nested cut groupby: one-hot launches {launches}, want >= 2")
    NESTED["onehot_launches"] += launches
    size = np.bincount(want_cut, minlength=16)
    mean = np.bincount(want_cut, weights=host_p.astype(np.float64), minlength=16) / size
    fp = fout.to_pandas()
    for what, m, s in (("Table", _host(out["mean"]), _host(out["size"])),
                       ("frame", fp["mean"].to_numpy(), fp["size"].to_numpy())):
        if not np.array_equal(s, size):
            raise AssertionError(f"nested cut groupby ({what}): sizes differ")
        np.testing.assert_allclose(m, mean, rtol=1e-5, err_msg=f"cut groupby ({what})")
    torch.cuda.synchronize()
    log(f"nested intervals: [{gpu}] cut(l_extendedprice, 16) over {n} rows first "
        f"{cut_s * 1e3:.2f} ms, warm {cut_warm * 1e3:.2f} ms; qcut(10) {qcut_s * 1e3:.2f} ms "
        f"(host quantiles included); codes equal pandas.cut/qcut exactly (pandas "
        f"{oracle_s:.1f} s); groupby(bin).agg(mean, size) Table API {gb_s * 1e3:.2f} ms, "
        f"frame {frame_s * 1e3:.2f} ms (host clock, synchronized), sizes exact and means "
        f"rtol 1e-5 against numpy; one-hot launches {launches}")
    _nested_done(t0)


def nested_sketches(gpu: str, tbl, df) -> None:
    """Step 5 (its first two parts): t-digest of l_extendedprice (60M rows)
    and the merge of 4 partition digests, quantiles within 0.01 in rank of
    the sorted column; approx_distinct_count(l_orderkey) within 5%."""
    import torch

    from cudf_tpu_torch import Column
    from cudf_tpu_torch.ops import tdigest as TD

    t0 = time.perf_counter()
    price = tbl["l_extendedprice"]
    n = price.length
    sk, td_s = synced(lambda: TD.tdigest(price, 100))
    _, td_warm = synced(lambda: TD.tdigest(price, 100))
    parts = [price.slice(i * n // 4, (i + 1) * n // 4 - i * n // 4) for i in range(4)]
    merged, merge_s = synced(lambda: TD.merge_tdigest([TD.tdigest(p, 100) for p in parts], 100))
    exact = torch.sort(price.data[:n].to(torch.float64)).values
    ranks = {}
    for what, d in (("whole", sk), ("merged", merged)):
        est = TD.tdigest_quantile(d, list(QUANTILES)).data[: len(QUANTILES)]
        r = (torch.searchsorted(exact, est).to(torch.float64) / n).cpu().numpy()
        ranks[what] = np.abs(r - np.asarray(QUANTILES))
        if (ranks[what] > 0.01).any():
            raise AssertionError(f"nested t-digest ({what}): rank errors {ranks[what]}")
    keys = Column.from_numpy(df["l_orderkey"].to_numpy())
    est, hll_s = synced(lambda: TD.approx_distinct_count([keys]))
    actual = int(torch.unique(keys.data[: keys.length]).numel())
    rel = abs(est - actual) / actual
    if rel > 0.05:
        raise AssertionError(f"nested HLL: {est} against {actual} distinct")
    log(f"nested sketches: [{gpu}] tdigest(l_extendedprice, 100) over {n} rows first "
        f"{td_s * 1e3:.2f} ms, warm {td_warm * 1e3:.2f} ms; 4 partition digests and their "
        f"merge {merge_s * 1e3:.2f} ms; quantiles {list(QUANTILES)} within "
        f"{max(ranks['whole'].max(), ranks['merged'].max()):.5f} in rank of the sorted "
        f"column (bound 0.01); approx_distinct_count(l_orderkey) {est} against {actual} "
        f"exact ({rel * 100:.3f}%, bound 5%) in {hll_s * 1e3:.2f} ms (host clock, "
        f"synchronized)")
    _nested_done(t0)


def _row_bytes(keys: np.ndarray, prices: np.ndarray) -> list:
    """The documented row message of [int64, f32] rows: little-endian bytes."""
    raw = np.empty(len(keys), dtype=[("k", "<i8"), ("p", "<f4")])
    raw["k"], raw["p"] = keys, prices
    b = raw.tobytes()
    return [b[i * 12: (i + 1) * 12] for i in range(len(keys))]


def nested_hashes(gpu: str, df) -> None:
    """Step 6: md5, sha256 and xxhash_64 of [l_orderkey, l_extendedprice]
    at NEST_HASH_ROWS rows, timed; all eight algorithms on a 1M-row slice,
    a 200,000-row sample of it held to hashlib and to the CPU path; and
    DataFrame.hash_values for every method."""
    import hashlib

    import torch

    from cudf_tpu_torch import Column, DataFrame, Series
    from cudf_tpu_torch.ops import crypto_hash as CH

    t0 = time.perf_counter()
    keys = df["l_orderkey"].to_numpy()
    prices = df["l_extendedprice"].to_numpy()
    cols = [Column.from_numpy(keys[:NEST_HASH_ROWS]),
            Column.from_numpy(prices[:NEST_HASH_ROWS])]
    times = {}
    for name, fn in (("md5", lambda: CH.md5(cols)), ("sha256", lambda: CH.sha256(cols)),
                     ("xxhash_64", lambda: CH.xxhash_64(cols))):
        out, first = synced(fn)
        _, warm = synced(fn)
        times[name] = (first, warm)
        if out.length != NEST_HASH_ROWS:
            raise AssertionError(f"nested {name}: {out.length} rows")
    m = NEST_HASH_SLICE
    sl = [c.slice(0, m) for c in cols]
    got = {a: CH.hexdigest(sl, a) for a in CH.DIGESTS}
    got["xxhash_32"], got["xxhash_64"] = CH.xxhash_32(sl, 7), CH.xxhash_64(sl, 7)
    torch.cuda.synchronize()
    rows = np.sort(np.random.default_rng(14).choice(m, NEST_HASH_SAMPLE, replace=False))
    msgs = _row_bytes(keys[rows], prices[rows])
    for a in CH.DIGESTS:
        col = got[a]
        codes = col.data[torch.from_numpy(rows).to(col.device)].cpu().numpy()
        want = [getattr(hashlib, a)(b).hexdigest() for b in msgs]
        if list(col.dictionary[codes]) != want:
            raise AssertionError(f"nested {a}: digests differ from hashlib")
    cpu = [Column.from_numpy(keys[rows], device="cpu"),
           Column.from_numpy(prices[rows], device="cpu")]
    def words(col):  # torch indexes no unsigned tensor on the card
        return col.data.view(torch.int32 if col.dtype.bits == 32 else torch.int64)

    for a, fn in (("xxhash_32", CH.xxhash_32), ("xxhash_64", CH.xxhash_64)):
        dev = words(got[a])[torch.from_numpy(rows).to(got[a].device)].cpu().numpy()
        if not np.array_equal(dev, words(fn(cpu, 7))[:NEST_HASH_SAMPLE].numpy()):
            raise AssertionError(f"nested {a}: the card differs from the CPU path")
    frame = DataFrame({"k": Series(column=sl[0]), "p": Series(column=sl[1])})
    for method in ("murmur3", "xxhash32", "xxhash64") + CH.DIGESTS:
        h = frame.hash_values(method)
        if len(h) != m:
            raise AssertionError(f"nested hash_values({method}): {len(h)} rows")
        if method in CH.DIGESTS and not torch.equal(h.column.data[:m], got[method].data[:m]):
            raise AssertionError(f"nested hash_values({method}) differs from {method}")
    log(f"nested hashes: [{gpu}] [l_orderkey, l_extendedprice] at {NEST_HASH_ROWS} rows: "
        + ", ".join(f"{k} first {v[0] * 1e3:.2f} ms, warm {v[1] * 1e3:.2f} ms"
                    for k, v in times.items())
        + f" (host clock, synchronized; a digest column's host dictionary included); all "
        f"eight algorithms on {m} rows: md5/sha* equal hashlib and xxhash_32/64 the CPU "
        f"path on a {NEST_HASH_SAMPLE}-row sample; hash_values ran every method")
    _nested_done(t0)


def nested_pack(gpu: str, tbl) -> None:
    """Step 7: pack phase 3's table (60M rows, 3 columns with masks),
    unpack it to the card exactly, and contiguous_split into 8 blobs, each
    equal to its slice of rows."""
    import torch

    from cudf_tpu_torch.ops import pack as P

    t0 = time.perf_counter()
    n = tbl.num_rows
    blob, pack_s = synced(lambda: P.pack(tbl))
    back, unpack_s = synced(lambda: P.unpack(blob))

    def same(a, b, rows, what):
        for name, c in a:
            d = b[name]
            if not torch.equal(c.data[:rows], d.data[:rows]) or \
                    (c.validity is None) != (d.validity is None) or \
                    (c.validity is not None and not torch.equal(c.validity[:rows],
                                                                 d.validity[:rows])):
                raise AssertionError(f"nested pack ({what}): column {name} differs")

    same(back, tbl, n, "unpack")
    bounds = [n * i // 8 for i in range(9)]
    pieces, split_s = synced(lambda: P.contiguous_split(tbl, bounds[1:-1]))
    for i, piece in enumerate(pieces):
        got = P.unpack(piece)
        if got.num_rows != bounds[i + 1] - bounds[i]:
            raise AssertionError(f"nested contiguous_split: piece {i} rows")
        same(got, tbl.slice(bounds[i], got.num_rows), got.num_rows, f"piece {i}")
    gb = blob.nbytes / 1e9
    log(f"nested pack: [{gpu}] {n} rows x {tbl.num_columns} columns with masks, "
        f"{gb:.3f} GB blob: pack {pack_s * 1e3:.2f} ms ({gb / pack_s:.2f} GB/s), unpack to "
        f"the card {unpack_s * 1e3:.2f} ms ({gb / unpack_s:.2f} GB/s), contiguous_split "
        f"into 8 {split_s * 1e3:.2f} ms (host clock, synchronized); every column, mask and "
        f"piece exact")
    _nested_done(t0)


def nested_collect(gpu: str, df) -> None:
    """Step 2: groupby_collect(l_orderkey) of l_extendedprice on the first
    CUT_ROWS rows against pandas' groupby(sort=True).agg(list), built with
    numpy (a stable argsort and run lengths), then list_sort."""
    from cudf_tpu_torch import Column, Table
    from cudf_tpu_torch.core.lists import groupby_collect
    from cudf_tpu_torch.ops.list_ops import list_sort

    t0 = time.perf_counter()
    keys = df["l_orderkey"].to_numpy()[:CUT_ROWS]
    prices = df["l_extendedprice"].to_numpy()[:CUT_ROWS]
    t = Table({"k": Column.from_numpy(keys), "p": Column.from_numpy(prices)})
    (kt, lists), first = synced(lambda: groupby_collect(t, ["k"], "p"))
    _, warm = synced(lambda: groupby_collect(t, ["k"], "p"))
    srt, sort_s = synced(lambda: list_sort(lists))
    order = np.argsort(keys, kind="stable")
    uk, counts = np.unique(keys, return_counts=True)
    offs = np.concatenate([[0], np.cumsum(counts)])
    if not np.array_equal(_host(kt["k"]), uk):
        raise AssertionError("nested collect: group keys differ")
    if not np.array_equal(lists.offsets.cpu().numpy(), offs):
        raise AssertionError("nested collect: offsets differ")
    if not np.array_equal(_host(lists.child), prices[order]):
        raise AssertionError("nested collect: child values differ")
    if not np.array_equal(_host(srt.child), prices[np.lexsort((prices, keys))]):
        raise AssertionError("nested list_sort: child values differ")
    log(f"nested collect: [{gpu}] groupby_collect over {CUT_ROWS} rows -> {len(uk)} lists: "
        f"first {first * 1e3:.2f} ms, warm {warm * 1e3:.2f} ms, list_sort "
        f"{sort_s * 1e3:.2f} ms (host clock, synchronized); keys, offsets and every child "
        f"value equal groupby(sort=True).agg(list), sorted lists exact")
    _nested_done(t0)


def nested_bloom(gpu: str, li, filtered, match) -> None:
    """Step 5 (its third part): a bloom filter over the filtered o_orderkey,
    probed with the 60M l_orderkey: no false negatives, and a false-positive
    share within twice the analytic one."""
    from cudf_tpu_torch.ops import bloom as B

    t0 = time.perf_counter()
    nb = filtered.num_rows
    bf, build_s = synced(lambda: B.build([filtered["o_orderkey"]], BLOOM_LOG2, BLOOM_K))
    hit, probe_s = synced(lambda: B.maybe_contains(bf, [li["l_orderkey"]]))
    got = _host(hit)
    if not got[match].all():
        raise AssertionError("nested bloom: a matched lineitem row was filtered out")
    fp = float(got[~match].mean())
    m = 1 << BLOOM_LOG2
    analytic = (1 - np.exp(-BLOOM_K * nb / m)) ** BLOOM_K
    if fp > 2 * analytic:
        raise AssertionError(f"nested bloom: false positives {fp}, analytic {analytic}")
    log(f"nested bloom: [{gpu}] build over {nb} o_orderkey (m = 2^{BLOOM_LOG2}, k = "
        f"{BLOOM_K}) {build_s * 1e3:.2f} ms, probe of {li.num_rows} l_orderkey "
        f"{probe_s * 1e3:.2f} ms (host clock, synchronized); no false negatives, "
        f"false-positive share {fp:.6f} (analytic {analytic:.6f}, bound twice that)")
    _nested_done(t0)


def nested_strings(gpu: str, k, pool, idx) -> None:
    """Step 1: split_record of phase 10's 16M rows, the list ops on it and
    explode + groupby against the pool's split; then the frame path:
    Series.str.split(expand=False), DataFrame.explode and merge with a
    vocabulary of the pool's middle tokens, with probe launches counted.
    The child's dictionary is the present middle tokens, then "page" and
    "url" (hex digits sort before both), so a row's middle token has its
    own code in ``k``."""
    import torch

    from cudf_tpu_torch import AggSpec, Column, DataFrame, Series, Table, dtypes
    from cudf_tpu_torch import groupby_aggregate
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.ops import list_ops as LO
    from cudf_tpu_torch.ops import strings as S
    from cudf_tpu_torch.ops.filling import sequence

    t0 = time.perf_counter()
    n = k.length
    lc, split_s = synced(lambda: S.split_record(k, "/"))
    d = lc.child.dictionary
    kd = k.dictionary
    D = len(d)
    if lc.length != n or lc.child.length != 3 * n or D != len(kd) + 2:
        raise AssertionError("nested split_record: sizes differ from the pool's")
    probe_rows = np.random.default_rng(1).integers(0, len(kd), 10_000)
    if list(d[-2:]) != ["page", "url"] or \
            [s[4:13] for s in kd[probe_rows]] != list(d[probe_rows]):
        raise AssertionError("nested split_record: the child dictionary differs")
    codes = k.data[:n].to(torch.int64)
    three = torch.stack([torch.full_like(codes, D - 1), codes, torch.full_like(codes, D - 2)], 1)
    if not torch.equal(lc.offsets.to(torch.int64), 3 * torch.arange(n + 1, device=codes.device)) \
            or not torch.equal(lc.child.data[:3 * n].to(torch.int64), three.reshape(-1)):
        raise AssertionError("nested split_record: lists differ from the pool's split")
    if not bool((lc.lengths().data[:n] == 3).all()):
        raise AssertionError("nested lengths")
    mid, extract_s = synced(lambda: lc.extract(1))
    if not torch.equal(mid.data[:n].to(torch.int64), codes) or not bool(mid.validity[:n].all()):
        raise AssertionError("nested extract(1) differs from the middle tokens")
    has, contains_s = synced(lambda: LO.list_contains(lc, "page"))
    if not bool(has.data[:n].all()):
        raise AssertionError("nested list_contains('page')")
    sorted_codes = three[:, [1, 2, 0]].reshape(-1)  # hex < "page" < "url"
    uniq, unique_s = synced(lambda: LO.list_unique(lc))
    srt, sort_s = synced(lambda: LO.list_sort(lc))
    for what, got in (("list_unique", uniq), ("list_sort", srt)):
        if not torch.equal(got.offsets.to(torch.int64), lc.offsets.to(torch.int64)) or \
                not torch.equal(got.child.data[:3 * n].to(torch.int64), sorted_codes):
            raise AssertionError(f"nested {what} differs from the pool's split")
    _, child = lc.explode()
    counts, gb_s = synced(lambda: groupby_aggregate(Table({"t": child}), ["t"],
                                                    [AggSpec("", "size", "n")]))
    want = np.bincount(_host(k), minlength=len(kd)).astype(np.int64)
    want = np.concatenate([want, [n, n]])
    if counts.num_rows != D or not np.array_equal(_host(counts["n"]), want):
        raise AssertionError("nested explode + groupby(token).size() differs from numpy")
    lists_s = time.perf_counter() - t0

    # the frame path
    t1 = time.perf_counter()
    # the pool's middle tokens f"{i:09x}", spelled as numpy str code points:
    # sorted and distinct, so they are their own dictionary
    digits = (np.arange(len(pool))[:, None] >> (4 * np.arange(8, -1, -1))) & 0xF
    hexes = np.where(digits < 10, digits + 48, digits + 87).astype("<u4").view(
        "<U9").reshape(-1)
    vid = sequence(len(pool), device=k.device)
    vocab = DataFrame({"tok": Series(column=Column(dtypes.string, vid.data.to(torch.int32),
                                                   None, len(pool), dictionary=hexes)),
                       "vid": Series(column=vid)})
    frame = DataFrame({"k": Series(column=k), "row": Series(column=sequence(n,
                                                                          device=k.device))})
    ht.probe_table.launches = 0

    def frame_path():
        parts = frame["k"].str.split("/", expand=False)
        exploded = DataFrame({"tok": parts, "row": frame["row"]}).explode("tok")
        return exploded, exploded.merge(vocab, on="tok")

    (exploded, merged), frame_s = synced(frame_path)
    launches = ht.probe_table.launches
    if launches < 1:
        raise AssertionError("nested frame merge did not launch the probe kernel")
    NESTED["probe_launches"] += launches
    if len(exploded) != 3 * n or len(merged) != n:
        raise AssertionError(f"nested frame: {len(exploded)} exploded, {len(merged)} merged")
    row, vid = _host(merged._tbl["row"]), _host(merged._tbl["vid"])
    order = np.argsort(row)
    if not np.array_equal(row[order], np.arange(n)) or not np.array_equal(vid[order], idx):
        raise AssertionError("nested frame: merged rows differ from the pool's tokens")
    log(f"nested strings: [{gpu}] split_record('/') of {n} rows ({len(kd)} distinct) -> "
        f"{lc.child.length} children {split_s * 1e3:.2f} ms, extract(1) "
        f"{extract_s * 1e3:.2f} ms, list_contains {contains_s * 1e3:.2f} ms, list_unique "
        f"{unique_s * 1e3:.2f} ms, list_sort {sort_s * 1e3:.2f} ms, explode+groupby(token)"
        f".size() {gb_s * 1e3:.2f} ms (host clock, synchronized); every list, length and "
        f"count equals the pool's split ({lists_s:.1f} s with checks)")
    log(f"nested strings: [{gpu}] frame str.split(expand=False) -> explode -> merge with "
        f"{len(pool)} vocabulary tokens: {frame_s:.2f} s (host clock, synchronized; each "
        f"distinct value split on the host once, by pyarrow), {len(merged)} rows equal "
        f"the generator's indices; probe launches {launches} "
        f"({time.perf_counter() - t1:.1f} s with the vocabulary and checks)")
    _nested_done(t0)


def nested_joins(gpu: str, host, dev) -> None:
    """Step 4 on phase 9's SF10 tables: mixed_join of lineitem with Q3's
    filtered orders on the order key and l_shipdate > o_orderdate + 60 days,
    for inner, left, semi and anti, against numpy; conditional_join of the
    first NEST_COND_ROWS lineitem rows with NEST_BANDS price bands, inner and
    left, against searchsorted; IR.ConditionalJoin equal to inner."""
    import torch

    from cudf_tpu_torch import Column, Table, apply_boolean_mask, binary_op
    from cudf_tpu_torch.expr import expressions as E
    from cudf_tpu_torch.expr import ir as IR
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.ops.join import conditional_join, mixed_join

    t0 = time.perf_counter()
    cutoff = np.datetime64("1995-03-15")
    days = np.timedelta64(60, "D")
    li = dev["lineitem"].select(["l_orderkey", "l_shipdate", "l_extendedprice"])
    od = dev["orders"].select(["o_orderkey", "o_orderdate"])
    filtered = apply_boolean_mask(od, binary_op(od["o_orderdate"], cutoff, "lt"))
    expr = E.col("l_shipdate") > E.col("o_orderdate") + E.Literal(days)
    pred = lambda t: E.evaluate(expr, t)  # noqa: E731
    hl, ho = host["lineitem"], host["orders"]
    lk = hl["l_orderkey"].to_numpy()
    odate = ho["o_orderdate"].to_numpy()  # o_orderkey is the row number
    ship = hl["l_shipdate"].to_numpy()
    hit = (odate[lk] < cutoff) & (ship > odate[lk] + days)
    rows = np.flatnonzero(hit)
    miss = np.flatnonzero(~hit)
    ship_i = ship.astype("datetime64[ns]").view(np.int64)
    ht.probe_table.launches = 0
    times = {}
    for how in ("inner", "left", "semi", "anti"):
        out, s = synced(lambda: mixed_join(li, filtered, ["l_orderkey"], ["o_orderkey"], pred,
                                           how))
        times[how] = s
        take = {"inner": rows, "semi": rows, "anti": miss,
                "left": np.concatenate([rows, miss])}[how]
        got_k, got_s = _host(out["l_orderkey"]), out["l_shipdate"].to_numpy()
        if not (np.array_equal(got_k, lk[take])
                and np.array_equal(got_s.astype("datetime64[ns]").view(np.int64),
                                   ship_i[take])
                and np.array_equal(_host(out["l_extendedprice"]),
                                   hl["l_extendedprice"].to_numpy()[take])):
            raise AssertionError(f"nested mixed_join {how}: rows differ from numpy")
        if how in ("inner", "left"):
            od_got = out["o_orderdate"].to_numpy()
            valid = ~np.isnat(od_got)
            if not np.array_equal(valid, np.arange(len(take)) < len(rows)) or \
                    not np.array_equal(od_got[valid].astype("datetime64[ns]"),
                                       odate[lk[rows]].astype("datetime64[ns]")):
                raise AssertionError(f"nested mixed_join {how}: o_orderdate differs")
    launches = ht.probe_table.launches
    if launches < 1:
        raise AssertionError("nested mixed_join did not launch the probe kernel")
    NESTED["probe_launches"] += launches

    edges = np.linspace(900.0, 105000.0, NEST_BANDS + 1)
    bands = Table({"lo": Column.from_numpy(edges[:-1]), "hi": Column.from_numpy(edges[1:]),
                   "band": Column.from_numpy(np.arange(NEST_BANDS))})
    lsub = dev["lineitem"].select(["l_extendedprice"]).slice(0, NEST_COND_ROWS)
    cond = (E.col("l_extendedprice") >= E.col("lo")) & (E.col("l_extendedprice") < E.col("hi"))
    p = hl["l_extendedprice"].to_numpy()[:NEST_COND_ROWS]
    b = np.searchsorted(edges, p, side="right") - 1
    inside = (b >= 0) & (b < NEST_BANDS)
    cond_times = {}
    for how in ("inner", "left"):
        out, s = synced(lambda: conditional_join(lsub, bands, lambda t: E.evaluate(cond, t),
                                                 how))
        cond_times[how] = s
        take = np.flatnonzero(inside) if how == "inner" else \
            np.concatenate([np.flatnonzero(inside), np.flatnonzero(~inside)])
        band = out["band"]
        valid = _valid(band)
        if not np.array_equal(_host(out["l_extendedprice"]), p[take]) or \
                not np.array_equal(valid, np.arange(len(take)) < inside.sum()) or \
                not np.array_equal(_host(band)[valid], b[take][valid]):
            raise AssertionError(f"nested conditional_join {how}: rows differ")
    plan = IR.ConditionalJoin(cond, "inner", children=(IR.DataFrameScan(lsub),
                                                       IR.DataFrameScan(bands)))
    ir_out, ir_s = synced(lambda: IR.execute(plan))
    if not np.array_equal(_host(ir_out["band"]), b[inside]):
        raise AssertionError("nested IR.ConditionalJoin differs from conditional_join")
    torch.cuda.synchronize()
    log(f"nested joins: [{gpu}] mixed_join of {li.num_rows} lineitem rows with "
        f"{filtered.num_rows} filtered orders on the key and l_shipdate > o_orderdate + 60 "
        f"days: " + ", ".join(f"{h} {s * 1e3:.2f} ms" for h, s in times.items())
        + f" ({len(rows)} rows pass); probe launches {launches}; conditional_join of "
        f"{NEST_COND_ROWS} rows x {NEST_BANDS} bands ({NEST_COND_ROWS * NEST_BANDS} pair "
        f"tests): " + ", ".join(f"{h} {s * 1e3:.2f} ms" for h, s in cond_times.items())
        + f", IR.ConditionalJoin {ir_s * 1e3:.2f} ms (host clock, synchronized); every "
        f"how equals numpy, the bands equal searchsorted")
    _nested_done(t0)


def nested_avro(gpu: str, host, tmp: str) -> None:
    """Step 8: NEST_AVRO_ROWS rows of [int64, double, string, nullable long]
    written with the null codec and read back through io.scan("avro"), and
    with deflate through IR.Scan("avro"), exactly (each read is a per-value
    host loop, so one read a codec)."""
    from cudf_tpu_torch import Table
    from cudf_tpu_torch import io as tio
    from cudf_tpu_torch.expr import ir as IR
    from cudf_tpu_torch.io.avro import write_avro

    t0 = time.perf_counter()
    hl = host["lineitem"].iloc[:NEST_AVRO_ROWS]
    supp = pd.array(hl["l_suppkey"].to_numpy(), dtype="Int64")
    supp[::10] = pd.NA
    src = pd.DataFrame({"k": hl["l_orderkey"].to_numpy(), "p": hl["l_extendedprice"].to_numpy(),
                        "s": hl["l_returnflag"].to_numpy(), "m": supp})
    tbl = Table.from_pandas(src)
    want = tbl.to_pandas()
    times = []
    for codec, how, read in (("null", "io.scan", lambda p: tio.scan("avro", [p])),
                             ("deflate", "IR.Scan",
                              lambda p: IR.execute(IR.Scan("avro", (p,))))):
        path = os.path.join(tmp, f"nested_{codec}.avro")
        _, w_s = synced(lambda: write_avro(tbl, path, codec))
        got, r_s = synced(lambda: read(path))
        pd.testing.assert_frame_equal(got.to_pandas(), want)
        times.append(f"{codec}: write {w_s:.2f} s, {how} {r_s:.2f} s "
                     f"({os.path.getsize(path) / 1e6:.1f} MB)")
    log(f"nested avro: [{gpu}] {NEST_AVRO_ROWS} rows of [int64, double, string, nullable "
        f"long]: " + "; ".join(times) + " (host clock, synchronized); each read equals the "
        f"table exactly")
    _nested_done(t0)


def nested_s3(gpu: str, scan_path: str, v) -> None:
    """Step 9: phase 11's scan file served by a local http.server on
    127.0.0.1 that answers HEAD and Range GETs and records each
    Authorization header; read_parquet('s3://bench/scan.parquet')['v'] with
    the endpoint there equals the written v, every request SigV4-signed."""
    import http.server
    import socketserver

    from cudf_tpu_torch.io import read_parquet

    t0 = time.perf_counter()
    seen = []
    size = os.path.getsize(scan_path)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_HEAD(self):
            seen.append(self.headers.get("Authorization"))
            self.send_response(200)
            self.send_header("Content-Length", str(size))
            self.end_headers()

        def do_GET(self):
            seen.append(self.headers.get("Authorization"))
            lo, hi = (int(x) for x in self.headers["Range"].split("=")[1].split("-"))
            with open(scan_path, "rb") as f:
                f.seek(lo)
                body = f.read(hi - lo + 1)
            self.send_response(206)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    env = {"AWS_ACCESS_KEY_ID": "AKIDCHIPSMOKE", "AWS_SECRET_ACCESS_KEY": "chip-smoke-secret",
           "AWS_DEFAULT_REGION": "us-east-1"}
    saved = {k: os.environ.get(k) for k in list(env) + ["AWS_ENDPOINT_URL"]}
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        os.environ.update(env, AWS_ENDPOINT_URL=f"http://127.0.0.1:{srv.server_address[1]}")
        t, read_s = synced(lambda: read_parquet("s3://bench/scan.parquet", columns=["v"]))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
        for k_, old in saved.items():
            if old is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = old
    if not np.array_equal(_host(t["v"]), v):
        raise AssertionError("nested s3: v differs from the local file's")
    if not seen or not all(a and a.startswith("AWS4-HMAC-SHA256 Credential=") for a in seen):
        raise AssertionError("nested s3: a request without a SigV4 Authorization header")
    log(f"nested s3: [{gpu}] read_parquet('s3://bench/scan.parquet', ['v']) through a local "
        f"endpoint on 127.0.0.1: {t.num_rows} rows in {read_s:.2f} s (host clock, "
        f"synchronized) over {len(seen)} SigV4-signed requests; v equals the written array")
    _nested_done(t0)


# --------------------------------------------------------------- phase 15
# The accelerator and decimal phase runs beside the phases whose data it
# reuses: the README quick start through cudf_tpu_torch.pandas_accel and the
# decimal64 ops, their groupby and the decimal128 ops on phase 3's 60M
# lineitem rows, the accelerator's merge and the join on decimal64 keys on
# phase 5's tables; the runner subprocess and the compatibility battery
# last.
ACCEL = {"seconds": 0.0, "onehot_launches": 0, "probe_launches": 0}
DEC128_ROWS = CUT_ROWS        # decimal128 mul, rescale, compare and sort
DEC_SAMPLE = 1_000_000        # of them held to Python ints where int64 cannot hold them
DEC_DIV_ROWS = 1_000_000      # decimal128 division on the host
RUNNER_ROWS = 1_000_000       # the runner subprocess's frame
RUNNER_SCRIPT = """\
import json
import numpy as np
import pandas as pd                      # the accelerator's module under the runner
import cudf_tpu_torch.pandas as accel
from cudf_tpu_torch.kernels import hashtable as ht
from cudf_tpu_torch.kernels import onehot_groupby as k
from cudf_tpu_torch.utils.real_pandas import pd as real_pd

rng = np.random.default_rng(15)
n = {rows}
data = {{"a": rng.integers(0, 3, n), "b": rng.integers(0, 2, n),
         "v": rng.uniform(900.0, 105000.0, n).astype(np.float32)}}
aggs = dict(avg=("v", "mean"), s=("v", "sum"), n=("v", "size"))
out = pd.DataFrame(data).dropna().groupby(["a", "b"]).agg(**aggs).to_pandas()
want = real_pd.DataFrame(data).astype({{"v": np.float64}}).groupby(["a", "b"]).agg(**aggs)
np.testing.assert_array_equal(out["n"].to_numpy(), want["n"].to_numpy())
np.testing.assert_allclose(out["avg"], want["avg"], rtol=1e-6)
np.testing.assert_allclose(out["s"], want["s"], rtol=1e-5)
print(json.dumps({{"accelerated": bool(getattr(pd, "__cudf_tpu_accel__", False)),
                  "groups": len(out), "onehot_launches": k.groupby_sum_count.launches,
                  "probe_launches": ht.probe_table.launches,
                  "fallbacks": accel.fallback_stats()}}))
"""


def _accel_done(t0: float) -> None:
    ACCEL["seconds"] += time.perf_counter() - t0


def _on_card(arr):
    import torch

    return torch.from_numpy(np.ascontiguousarray(arr)).cuda()


def _exact(what: str, got, want) -> None:
    """A device tensor equal to a host array, every element."""
    import torch

    if not torch.equal(got, _on_card(want)):
        raise AssertionError(f"{what}: differs from the numpy oracle")


def accel_readme(gpu: str, df, frame) -> None:
    """The README quick start as pandas code through
    ``cudf_tpu_torch.pandas_accel.install()``: P.DataFrame(phase 3's host
    frame) -> dropna -> groupby(KEYS).agg(mean, sum, size) -> to_pandas.
    Equal to the port's frame path exactly and to pandas within the frame
    phase's tolerance; one-hot launches >= 1, no probe, no fallback."""
    import cudf_tpu_torch.pandas_accel as accel
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as k

    t_start = time.perf_counter()
    q1 = df[KEYS + ["l_extendedprice"]]
    aggs = dict(avg=("l_extendedprice", "mean"), s=("l_extendedprice", "sum"),
                n=("l_extendedprice", "size"))
    P = accel.install()
    try:
        before = accel.fallback_stats()
        k.groupby_sum_count.launches = 0
        ht.probe_table.launches = 0
        xdf = P.DataFrame(q1)
        out, first_s = synced(lambda: xdf.dropna().groupby(KEYS).agg(**aggs).to_pandas())
        launches = k.groupby_sum_count.launches
        if launches < 1:
            raise AssertionError("the accelerator's quick start did not launch the one-hot "
                                 "kernel")
        if ht.probe_table.launches:
            raise AssertionError("the accelerator's quick start launched the probe kernel")
        _, warm_s = synced(lambda: xdf.dropna().groupby(KEYS).agg(**aggs))
        _, frame_s = synced(lambda: frame.dropna().groupby(KEYS).agg(**aggs))
        traced = traced_ranges(lambda: xdf.dropna().groupby(KEYS).agg(**aggs))
        if accel.fallback_stats() != before:
            raise AssertionError(f"the accelerator's quick start fell back: "
                                 f"{accel.fallback_stats()}")
    finally:
        accel.uninstall()
    pd.testing.assert_frame_equal(out, frame.dropna().groupby(KEYS).agg(**aggs).to_pandas(),
                                  check_exact=True)
    want = (q1.dropna().astype({"l_extendedprice": np.float64})
            .groupby(KEYS, sort=True)["l_extendedprice"].agg(["mean", "sum", "size"]))
    np.testing.assert_array_equal(out["n"].to_numpy(), want["size"].to_numpy())
    np.testing.assert_allclose(out["avg"], want["mean"], rtol=1e-6)
    np.testing.assert_allclose(out["s"], want["sum"], rtol=1e-5)
    log(f"accel: [{gpu}] P = pandas_accel.install(); P.DataFrame({len(q1)} rows).dropna()"
        f".groupby(KEYS).agg(mean, sum, size).to_pandas() {first_s:.3f} s (first, ingest "
        f"included), {warm_s * 1e3:.2f} ms warm without to_pandas, the frame's "
        f"{frame_s * 1e3:.2f} ms beside it (host clock, synchronized); one-hot launches "
        f"{launches}, no fallback; equal to the frame path exactly and to pandas (sizes "
        f"exact, mean rtol 1e-6, sum rtol 1e-5); {time.perf_counter() - t_start:.1f} s "
        f"with the checks")
    log(f"tracing: [{gpu}] {traced}")
    ACCEL["onehot_launches"] += launches
    _accel_done(t_start)


def traced_ranges(fn) -> str:
    """One fn() call under ``utils.tracing.profiler_trace``: the chrome trace
    it writes must hold the ``groupby_aggregate`` range that
    ``ops/groupby.py``'s ``trace_op`` opens, and device kernels. Also the
    host cost of an empty ``annotate`` range, with ``performance_tracking``
    off (the default)."""
    import torch

    from cudf_tpu_torch.utils import tracing

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        stop = tracing.profiler_trace(tmp)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            stop()
        files = [os.path.join(d, f) for d, _, fs in os.walk(tmp) for f in fs
                 if f.endswith(".json")]
        if not files:
            raise AssertionError("profiler_trace wrote no trace")
        events = json.load(open(files[0]))["traceEvents"]
    ranges = [e for e in events if e.get("name") == "groupby_aggregate"
              and e.get("cat") == "user_annotation"]
    spans = [e for e in events if e.get("name") == "groupby_aggregate"
             and e.get("cat") == "gpu_user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if len(ranges) != 1 or not kernels:
        raise AssertionError(f"the trace holds {len(ranges)} groupby_aggregate ranges and "
                             f"{len(kernels)} device kernels")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.annotate("x"):
            pass
    empty_us = (time.perf_counter() - t0) / n * 1e6
    span = (f", its device span {spans[0].get('dur', 0):.0f} us" if spans
            else ", no device span")
    return (f"one warm quick start under utils.tracing.profiler_trace: the chrome trace "
            f"holds one groupby_aggregate range of {ranges[0].get('dur', 0):.0f} us on the "
            f"host{span}, and {len(kernels)} device kernels; an empty annotate range costs "
            f"{empty_us:.2f} us of host time (mean of {n}, performance_tracking off, "
            f"NVTX and record_function on)")


def accel_merge(gpu: str, df, od, want) -> None:
    """P.merge of phase 5's filtered orders (7,289,153 rows) with the 60M
    lineitem rows through the accelerator: one probe launch, no fallback,
    row for row equal to the oracle, as phase 12's DataFrame.merge."""
    import cudf_tpu_torch.pandas_accel as accel
    from cudf_tpu_torch.kernels import hashtable as ht

    t_start = time.perf_counter()
    keep = od["o_orderdate"].to_numpy() < Q3_DAY
    P = accel.install()
    try:
        before = accel.fallback_stats()
        left = P.DataFrame(df[["l_orderkey", "l_extendedprice"]])
        right = P.DataFrame(od[keep])
        ht.probe_table.launches = 0

        def merge():
            return P.merge(left, right, left_on="l_orderkey", right_on="o_orderkey")

        merged, first_s = synced(merge)
        launches = ht.probe_table.launches
        if launches != 1:
            raise AssertionError(f"P.merge launched the probe kernel {launches} times")
        _, warm_s = synced(merge)
        if accel.fallback_stats() != before:
            raise AssertionError(f"P.merge fell back: {accel.fallback_stats()}")
    finally:
        accel.uninstall()
    assert_rows(_columns(merged._fast_obj().table, JOIN_COLS), want, "accelerator merge",
                False)
    log(f"accel: [{gpu}] P.merge({len(df)} lineitem rows, {int(keep.sum())} filtered "
        f"orders) -> {len(merged)} rows {first_s * 1e3:.2f} ms (first, ingest included), "
        f"{warm_s * 1e3:.2f} ms warm (host clock, synchronized); probe launches {launches}, "
        f"no fallback; equal to the oracle row for row; {time.perf_counter() - t_start:.1f} "
        f"s with the checks")
    ACCEL["probe_launches"] += launches
    _accel_done(t_start)


def accel_runner(gpu: str, tmp: str) -> None:
    """python -m cudf_tpu_torch.pandas on a script holding the quick start
    (RUNNER_ROWS rows): it checks itself against pandas and prints its
    launch counts and fallback stats, which must show the one-hot kernel
    and no fallback."""
    t_start = time.perf_counter()
    script = os.path.join(tmp, "quick_start.py")
    with open(script, "w") as f:
        f.write(RUNNER_SCRIPT.format(rows=RUNNER_ROWS))
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run([sys.executable, "-m", "cudf_tpu_torch.pandas", script],
                       capture_output=True, text=True, timeout=300, cwd=tmp, env=env)
    if r.returncode != 0:
        raise AssertionError(f"the runner failed ({r.returncode}): {r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if not res["accelerated"] or res["onehot_launches"] < 1 or res["fallbacks"]:
        raise AssertionError(f"the runner's script did not run on the engine: {res}")
    log(f"accel: [{gpu}] python -m cudf_tpu_torch.pandas quick_start.py ({RUNNER_ROWS} "
        f"rows) {time.perf_counter() - t_start:.1f} s (host clock, process start "
        f"included): {json.dumps(res)}; equal to pandas")
    _accel_done(t_start)


PREWARM_ROWS = CUT_ROWS
PREWARM_SCRIPT = """\
import json, time
import numpy as np
import torch
import cudf_tpu_torch
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops.sorting import sort_by_key

n, warm = {rows}, {warm}
keys = np.random.default_rng(15).integers(0, 1 << 40, n)
tbl = Table({{"k": Column.from_numpy(keys, device="cuda")}})
torch.cuda.synchronize()
t0 = time.perf_counter()
if warm:
    cudf_tpu_torch.prewarm(n, background=False)
t1 = time.perf_counter()
out = sort_by_key(tbl, ["k"])
torch.cuda.synchronize()
t2 = time.perf_counter()
sort_by_key(tbl, ["k"])
torch.cuda.synchronize()
t3 = time.perf_counter()
assert np.array_equal(out["k"].to_numpy(), np.sort(keys))
print(json.dumps({{"prewarm_s": t1 - t0, "first_ms": (t2 - t1) * 1e3,
                  "second_ms": (t3 - t2) * 1e3}}))
"""


def prewarm_first_call(gpu: str) -> None:
    """The first sort_by_key of PREWARM_ROWS int64 keys in a fresh process,
    without ``cudf_tpu_torch.prewarm`` and after it, then a second call;
    each process makes its CUDA context and its column before the clock
    starts, so the two first calls differ by what prewarm did."""
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    res = {}
    for warm in (False, True):
        r = subprocess.run([sys.executable, "-c",
                            PREWARM_SCRIPT.format(rows=PREWARM_ROWS, warm=warm)],
                           capture_output=True, text=True, timeout=300, cwd=root, env=env)
        if r.returncode != 0:
            raise AssertionError(f"the prewarm probe failed ({r.returncode}): "
                                 f"{r.stderr[-3000:]}")
        res[warm] = json.loads(r.stdout.strip().splitlines()[-1])
    cold, warm = res[False], res[True]
    log(f"prewarm: [{gpu}] first sort_by_key of {PREWARM_ROWS} int64 keys in a fresh "
        f"process: {cold['first_ms']:.2f} ms without prewarm (second call "
        f"{cold['second_ms']:.2f} ms), {warm['first_ms']:.2f} ms after "
        f"prewarm({PREWARM_ROWS}, background=False), which took "
        f"{warm['prewarm_s'] * 1e3:.2f} ms with the kernels built already (second call "
        f"{warm['second_ms']:.2f} ms); host clock, synchronized; both sorted exactly; "
        f"{time.perf_counter() - t_start:.1f} s with process starts")
    _accel_done(t_start)


def accel_battery(gpu: str) -> None:
    """benchmarks/pandas_compat.py's 49 cases (its CASES, _data and
    _compare) through the accelerator on the card; the pass rate must be
    1.00. Then neither jax nor cudf_tpu may have been imported."""
    import importlib.util
    import traceback

    import cudf_tpu_torch.pandas_accel as accel

    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "pandas_compat", os.path.join(root, "benchmarks", "pandas_compat.py"))
    battery = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(battery)
    df, other = battery._data()
    passed, fast, failures = 0, 0, []
    P = accel.install()
    try:
        for name, fn in battery.CASES:
            before = accel.fallback_stats()
            try:
                ok = battery._compare(fn(P, df, other), fn(pd, df.copy(), other.copy()))
            except Exception:  # a case that raises is a failed case, reported below
                ok = False
                failures.append(f"{name}: {traceback.format_exc(limit=2).splitlines()[-1]}")
            passed += bool(ok)
            fast += bool(ok) and accel.fallback_stats() == before
    finally:
        accel.uninstall()
    total = len(battery.CASES)
    log(f"accel: [{gpu}] benchmarks/pandas_compat.py battery: {passed}/{total} passed, "
        f"pass rate {passed / total:.3f}, fast rate {fast / total:.3f} "
        f"({time.perf_counter() - t_start:.1f} s, host clock)")
    if passed < total:
        raise AssertionError("battery failures: " + "; ".join(failures))
    bad = [m for m in sys.modules if m in ("jax", "cudf_tpu") or m.startswith(("jax.",
                                                                              "cudf_tpu."))]
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")
    log("accel: neither jax nor cudf_tpu is in sys.modules")
    _accel_done(t_start)


def decimal_ops(gpu: str, tbl, df) -> None:
    """On phase 3's rows: l_extendedprice from_floats at scale -2, a seeded
    l_discount of integers 0..10 at scale -2 (TPC-H's 0.00..0.10), and
    price * (1 - disc) at scale -4, its int64 sum exact against numpy's;
    round (half even), rescale (half away from zero) and compare against
    numpy int64 on the unscaled data; groupby(l_discount) of the f32 price;
    then the decimal128 ops (decimal128_ops)."""
    from cudf_tpu_torch import AggSpec, Column, Table, groupby_aggregate
    from cudf_tpu_torch.kernels import onehot_groupby as k
    from cudf_tpu_torch.ops import decimal as D

    t_start = time.perf_counter()
    n = tbl.num_rows
    x = df["l_extendedprice"].to_numpy().astype(np.float64) * 100.0
    pu = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)
    disc_np = np.random.default_rng(15).integers(0, 11, n)
    net_np = pu * (100 - disc_np)
    times = {}
    price, times["from_floats"] = synced(lambda: D.from_floats(tbl["l_extendedprice"], -2))
    disc = D.from_integers(Column.from_numpy(disc_np), -2)
    one = D.from_integers(Column.from_scalar(1, n), 0)
    net, times["price * (1 - disc)"] = synced(
        lambda: D.binary_op(price, D.binary_op(one, disc, "sub"), "mul"))
    _exact("from_floats", price.data[:n], pu)
    if net.dtype.param != -4:
        raise AssertionError(f"price * (1 - disc) has scale {net.dtype.param}")
    _exact("price * (1 - disc)", net.data[:n], net_np)
    total, times["sum"] = synced(lambda: int(net.data[:n].sum()))
    if total != int(net_np.sum()):
        raise AssertionError(f"decimal sum {total}, numpy {int(net_np.sum())}")
    a = np.abs(net_np)
    q, r = a // 100, a % 100
    even = np.where(net_np < 0, -1, 1) * (q + ((2 * r > 100) | ((2 * r == 100) & (q % 2 == 1))))
    away = np.where(net_np < 0, -1, 1) * ((a + 50) // 100)
    rounded, times["round_decimal(2, half_even)"] = synced(
        lambda: D.round_decimal(net, 2, "half_even"))
    _exact("round_decimal", rounded.data[:n], even)
    resc, times["rescale(-2)"] = synced(lambda: D.rescale(net, -2))
    _exact("rescale", resc.data[:n], away)
    gt, times["price > rescaled"] = synced(lambda: D.binary_op(price, resc, "gt"))
    _exact("compare", gt.data[:n], pu > away)
    strs = D.to_strings(price.slice(0, 1000)).to_numpy()
    if list(strs) != [f"{u // 100}.{u % 100:02d}" for u in pu[:1000].tolist()]:
        raise AssertionError("to_strings differs from the unscaled values' spelling")
    log(f"decimal: [{gpu}] {n} rows: price from_floats(-2), l_discount 0..10 at -2, "
        f"price * (1 - disc) at -4 with its sum {total} exact against numpy int64; "
        f"round, rescale and compare exact; " + ", ".join(
            f"{k_} {v * 1e3:.2f} ms" for k_, v in times.items())
        + " (host clock, synchronized, first call)")

    t = Table({"l_discount": disc, "l_extendedprice": tbl["l_extendedprice"]})
    aggs = [AggSpec("l_extendedprice", "sum", "s"), AggSpec("", "size", "n")]
    k.groupby_sum_count.launches = 0
    out, g_s = synced(lambda: groupby_aggregate(t, ["l_discount"], aggs))
    launches = k.groupby_sum_count.launches
    if launches < 1:
        raise AssertionError("groupby(l_discount) did not take the one-hot lane")
    cnt = np.bincount(disc_np, minlength=11)
    _exact("groupby keys", out["l_discount"].data[:11], np.arange(11, dtype=np.int64))
    np.testing.assert_array_equal(out["n"].to_numpy(), cnt)
    np.testing.assert_allclose(out["s"].to_numpy(), np.bincount(
        disc_np, weights=df["l_extendedprice"].to_numpy().astype(np.float64)), rtol=1e-5)
    _, g_warm = synced(lambda: groupby_aggregate(t, ["l_discount"], aggs))
    log(f"decimal: [{gpu}] groupby(l_discount, a decimal64 key).agg(sum, size) of the "
        f"f32 price: {out.num_rows} groups on the one-hot lane (launches {launches}), "
        f"{g_s * 1e3:.2f} ms first, {g_warm * 1e3:.2f} ms warm (host clock, "
        f"synchronized); keys and sizes exact, sums rtol 1e-5; {time.perf_counter() - t_start:.1f} "
        f"s since the decimal64 data was made, numpy oracles included")
    ACCEL["onehot_launches"] += launches
    del t, out, rounded, resc, gt
    decimal128_ops(gpu, net, net_np, price, pu, disc, disc_np)
    _accel_done(t_start)


def decimal128_ops(gpu: str, net, net_np, price, pu, disc, disc_np) -> None:
    """Decimal128 on the first DEC128_ROWS rows: from_decimal64 of the
    product less 50,000 (signs mixed), mul by the price (scale -6, exact
    against int64), its square (past 2^64: the low limb against numpy's
    wrapping int64 product, every limb against Python ints on DEC_SAMPLE
    rows), rescale to -6 and compare, and the order of order_operands
    through multisort_perm against a stable numpy argsort; then division on
    the host of DEC_DIV_ROWS rows by l_discount (zeros give nulls) against
    Python's decimal."""
    import decimal as pydec

    import torch

    from cudf_tpu_torch.ops import decimal as D
    from cudf_tpu_torch.ops import decimal128 as D128
    from cudf_tpu_torch.ops.sortprim import multisort_perm

    t_start = time.perf_counter()
    m = DEC128_ROWS
    times = {}
    a = D.binary_op(net.slice(0, m), 50_000, "sub")
    a_np = net_np[:m] - 50_000 * 10 ** 4
    A = D128.Decimal128Column.from_decimal64(a)
    B = D128.Decimal128Column.from_decimal64(price.slice(0, m))
    prod, times["mul"] = synced(lambda: D128.binary_op(A, B, "mul"))
    p_np = a_np * pu[:m]
    _exact("decimal128 mul, low limb", prod.lo[:m], p_np)
    _exact("decimal128 mul, high limb", prod.hi[:m], np.where(p_np < 0, -1, 0))
    sq, times["mul (past 2^64)"] = synced(lambda: D128.binary_op(prod, prod, "mul"))
    with np.errstate(over="ignore"):
        _exact("decimal128 square, low limb", sq.lo[:m], p_np * p_np)
    rs, times["rescale(-6)"] = synced(lambda: D128.rescale(sq, -6))
    s = DEC_SAMPLE
    pys = [int(v) for v in p_np[:s].tolist()]
    hi, lo = sq.hi[:s].cpu().numpy().tolist(), sq.lo[:s].cpu().numpy().view(np.uint64).tolist()
    if any((h << 64) | l != v * v for h, l, v in zip(hi, lo, pys)):
        raise AssertionError("decimal128 square differs from Python ints")
    hi, lo = rs.hi[:s].cpu().numpy().tolist(), rs.lo[:s].cpu().numpy().view(np.uint64).tolist()
    if any((h << 64) | l != (v * v + 500_000) // 10 ** 6 for h, l, v in zip(hi, lo, pys)):
        raise AssertionError("decimal128 rescale differs from Python ints")
    gt, times["compare"] = synced(lambda: D128.binary_op(prod, A, "gt"))
    _exact("decimal128 compare", gt.data[:m], p_np > a_np * 100)
    perm, times["multisort_perm(order_operands)"] = synced(
        lambda: multisort_perm(D128.order_operands(sq)))
    _exact("decimal128 sort", perm[perm < m], np.argsort(np.abs(p_np), kind="stable"))
    log(f"decimal128: [{gpu}] {m} rows: mul exact against int64, the square past 2^64 "
        f"(low limb exact against numpy, every limb against Python ints on {s} rows), "
        f"rescale and compare exact, the sort by order_operands equal to numpy's stable "
        f"argsort; " + ", ".join(f"{k_} {v * 1e3:.2f} ms" for k_, v in times.items())
        + " (host clock, synchronized, first call)")
    del sq, rs, gt, perm

    r = DEC_DIV_ROWS
    num = D128.Decimal128Column(prod.hi[:r], prod.lo[:r], prod.scale, None, r)
    den = D128.Decimal128Column.from_decimal64(disc.slice(0, r))
    quo, div_s = synced(lambda: D128.binary_op(num, den, "div"))
    got = quo.to_python()
    with pydec.localcontext() as ctx:
        ctx.prec = 60
        for x, y, g in zip(p_np[:r].tolist(), disc_np[:r].tolist(), got):
            want = None if y == 0 else int((pydec.Decimal(x) / pydec.Decimal(y))
                                           .to_integral_value(pydec.ROUND_DOWN))
            if g != want:
                raise AssertionError(f"decimal128 {x} / {y}: {g}, Python's decimal {want}")
    log(f"decimal128: [{gpu}] division on the host, {r} rows by l_discount at scale "
        f"{quo.scale} ({int((disc_np[:r] == 0).sum())} zeros give nulls): {div_s:.2f} s "
        f"(host clock), equal to Python's decimal; decimal128 {time.perf_counter() - t_start:.1f} "
        f"s with the checks")
    torch.cuda.empty_cache()


def decimal_join(gpu: str, li, filtered, want) -> None:
    """Phase 5's join with both keys as decimal64 (scale -2): the hash-table
    lane with the probe kernel (ordered, so the filtered orders stay the
    build side), equal to the oracle row for row."""
    from cudf_tpu_torch import Table, join
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.ops import decimal as D

    t_start = time.perf_counter()
    ld = Table({"l_orderkey": D.from_integers(li["l_orderkey"], -2),
                "l_extendedprice": li["l_extendedprice"]})
    rd = Table({c: (D.from_integers(filtered[c], -2) if c == "o_orderkey" else filtered[c])
                for c in filtered.names})
    ht.probe_table.launches = 0
    out, first_s = synced(lambda: join(ld, rd, ["l_orderkey"], ["o_orderkey"], "inner"))
    launches = ht.probe_table.launches
    if launches < 1:
        raise AssertionError("the join on decimal64 keys did not launch the probe kernel")
    if out["l_orderkey"].dtype.param != -2:
        raise AssertionError(f"joined key dtype {out['l_orderkey'].dtype}")
    assert_rows(_columns(out, JOIN_COLS), want, "decimal64 join", False)
    _, warm_s = synced(lambda: join(ld, rd, ["l_orderkey"], ["o_orderkey"], "inner"))
    log(f"decimal: [{gpu}] join on decimal64 keys {li.num_rows} x {filtered.num_rows} -> "
        f"{out.num_rows} rows {first_s * 1e3:.2f} ms first, {warm_s * 1e3:.2f} ms warm "
        f"(host clock, synchronized); probe launches {launches}; equal to the oracle; "
        f"{time.perf_counter() - t_start:.1f} s with the checks")
    ACCEL["probe_launches"] += launches
    _accel_done(t_start)


# --------------------------------------------------------------- phase 16
# The distributed phase runs beside the phases whose data it reuses: the
# README groupby over 8 shards on phase 3's table, the Q3 shuffle join on
# phase 5's tables, the distributed sort on phase 8's table, execute_spmd,
# the broadcast joins and execute_streaming on phase 9's SF10 tables, and
# last two processes sharing the card. The mesh is 8 shards, the reference's
# 8-device count (MULTICHIP_r*.json's n_devices), round-robin over the
# visible cards: on one H100 all 8 share cuda:0. DIST sums its seconds and
# the kernels' launches.
DIST = {"seconds": 0.0, "onehot_launches": 0, "probe_launches": 0}
DIST_SHARDS = 8
MP_ROWS = 6_000_000          # the two processes' lineitem: SF1
MP_TIMEOUT_S = 300           # a worker still running then is killed, and the phase fails
MP_SCRIPT = """\
import json, os, sys, time
import numpy as np, pandas as pd, torch
import chip_smoke as cs
from cudf_tpu_torch import Table
from cudf_tpu_torch.expr import expressions as E, ir as IR
from cudf_tpu_torch.parallel import multihost
from cudf_tpu_torch.parallel.multiproc_stream import execute_multiproc

rank, nccl = int(os.environ["CUDF_TPU_PROCESS_ID"]), sys.argv[1] == "nccl"
if nccl:
    # one card a rank: the process group runs NCCL and the mesh's exchange
    # is all_to_all_single between the cards
    from cudf_tpu_torch.ops.groupby import AggSpec
    from cudf_tpu_torch.parallel import spmd
    multihost.initialize()
    n = multihost.process_count()
    mesh = multihost.global_mesh(n_devices=n)
    df = cs.lineitem(int(sys.argv[2]), seed=0)[cs.KEYS + ["l_extendedprice"]]
    part = df.iloc[rank::n].reset_index(drop=True)
    st = spmd.ShardedTable.from_process_local([Table.from_pandas(part)], mesh)
    aggs = [AggSpec("l_extendedprice", "sum", "s"), AggSpec("", "size", "n")]
    out = spmd.dist_groupby(st, cs.KEYS, aggs).local_tables()[0].to_pandas()
    srt = spmd.dist_sort_values(st, ["l_extendedprice"], descending=True).local_tables()[0]
    v = srt["l_extendedprice"].data[: srt.num_rows].cpu().numpy().astype(float)
    print(json.dumps({"rank": rank, "groups": out.to_dict(orient="list"),
                      "sort": [len(v), bool((np.diff(v) <= 0).all()),
                               v[:1].tolist(), v[-1:].tolist()]}), flush=True)
    sys.exit(0)
# two ranks on one card: the group (gloo) only coordinates; the tables stay on
# the card and partitions cross through multihost.host_exchange
multihost.initialize(device="cpu")
host = cs.gen_tables(int(sys.argv[2]))
dev = {k: Table.from_pandas(v) for k, v in host.items()}
plans = {q: cs.BUILDERS[q](lambda n: IR.DataFrameScan(dev[n]), E, IR, E.col)
         for q in ("q1", "q3")}
res = {"rank": rank}
for q, plan in plans.items():
    want = IR.execute(plan).to_pandas()
    got = execute_multiproc(plan, collect="global").to_pandas()
    pd.testing.assert_frame_equal(got, want, rtol=1e-9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    execute_multiproc(plan, collect="global")
    torch.cuda.synchronize()
    res[q] = {"rows": len(got), "warm_ms": (time.perf_counter() - t0) * 1e3}
li = dev["lineitem"]
half = li.num_rows // 2
sends = [li.slice(0, half), li.slice(half)]
t0 = time.perf_counter()
got = multihost.host_exchange(sends, timeout_ms=120_000)
res["exchange_s"] = time.perf_counter() - t0
mine = sends[rank]
for src, t in enumerate(got):
    if t.num_rows != mine.num_rows or not torch.equal(
            t["l_orderkey"].data[: t.num_rows], mine["l_orderkey"].data[: t.num_rows]):
        raise AssertionError(f"host_exchange: rank {src}'s partition differs")
res["exchange_rows"] = sum(t.num_rows for t in got)
print(json.dumps(res), flush=True)
"""


def _dist_done(t0: float) -> None:
    DIST["seconds"] += time.perf_counter() - t0


def _dist_mesh():
    from cudf_tpu_torch.parallel import spmd

    return spmd.make_mesh(DIST_SHARDS)


def _dist_shard(tbl, mesh):
    """``tbl``'s rows in DIST_SHARDS contiguous slices, one a shard."""
    from cudf_tpu_torch.parallel import spmd

    n = tbl.num_rows
    step = -(-n // mesh.size)
    return spmd.ShardedTable.from_tables(
        [tbl.slice(min(i * step, n), step) for i in range(mesh.size)], mesh)


def _dist_line(what: str, lengths, mesh, launches: str) -> str:
    """Shards, rows a shard, bytes exchanged, exchange against shard-local
    time (the timed run) and launches of one distributed op."""
    from cudf_tpu_torch.parallel import spmd

    st = mesh.stats
    return (f"{what}: {mesh.size} shards, rows a shard {min(lengths)}..{max(lengths)}; "
            f"{st.exchanges} exchanges moved {st.exchange_bytes} bytes between shards; "
            f"exchange {st.exchange_s * 1e3:.2f} ms, shard-local ops {st.local_s * 1e3:.2f} ms "
            f"(synchronized run); {launches}; fallbacks {dict(spmd.DIST_FALLBACK_COUNTS)}")


def _dist_run(mesh, fn):
    """fn() twice: once with the mesh's step timing on (the mesh keeps
    that run's stats), once warm with it off; returns (result, warm
    seconds)."""
    import torch

    mesh.reset_stats()
    mesh.timing = True
    torch.cuda.synchronize()
    out = fn()
    mesh.timing = False
    timed = mesh.stats
    mesh.reset_stats()
    _, warm_s = synced(fn)
    mesh.stats = timed
    return out, warm_s


def dist_readme(gpu: str, tbl, readme_out) -> None:
    """Collective 1: dist_groupby of the README query over phase 3's 60M
    rows in 8 shards (keys with 1% nulls each: like the reference's shard
    body, null keys form groups). The groups with both keys equal phase 3's
    answer (keys and counts exact, sums and means rtol 1e-5, the kernel's
    f32 partial sums), every row counted; the one-hot kernel launched once
    for each shard that holds rows and never for an empty one."""
    from cudf_tpu_torch import AggSpec, groupby_aggregate
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as oh
    from cudf_tpu_torch.parallel import spmd

    t0 = time.perf_counter()
    mesh = _dist_mesh()
    log(f"dist: [{gpu}] mesh {mesh}")
    aggs = [AggSpec("l_extendedprice", "sum", "sum_price"),
            AggSpec("l_extendedprice", "mean", "avg_price"),
            AggSpec("l_extendedprice", "count", "count_price"),
            AggSpec("", "size", "count_order")]
    st = _dist_shard(tbl, mesh)
    shuffled, _ = spmd.shuffle_by_key(st, KEYS)
    lengths = shuffled.lengths
    holding = sum(n > 0 for n in lengths)
    del shuffled
    spmd.reset_dist_fallbacks()
    oh.groupby_sum_count.launches = 0
    ht.probe_table.launches = 0
    out, warm_s = _dist_run(mesh, lambda: spmd.dist_groupby(st, KEYS, aggs))
    if oh.groupby_sum_count.launches != 2 * holding:
        raise AssertionError(f"dist groupby: {oh.groupby_sum_count.launches} one-hot "
                             f"launches in two runs for {holding} shards that hold rows")
    launches = holding
    if ht.probe_table.launches:
        raise AssertionError("dist groupby launched the probe kernel")
    DIST["onehot_launches"] += launches
    line = _dist_line("dist groupby (rows after the shuffle)", lengths, mesh,
                      f"one-hot launches {launches} a run ({holding} shards hold rows)")
    _, mem_s = synced(lambda: groupby_aggregate(tbl, KEYS, aggs, dropna_keys=False))
    got = out.concat_to_table().to_pandas()
    if int(got["count_order"].sum()) != tbl.num_rows:
        raise AssertionError("dist groupby: the groups do not count every row")
    got = got.dropna(subset=KEYS).sort_values(KEYS).reset_index(drop=True)
    want = readme_out.sort_values(KEYS).reset_index(drop=True)
    np.testing.assert_array_equal(got[KEYS].to_numpy(np.int64), want[KEYS].to_numpy(np.int64))
    for c in ("count_price", "count_order"):
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy())
    for c in ("sum_price", "avg_price"):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-5)
    if spmd.DIST_FALLBACK_COUNTS:
        raise AssertionError(f"dist fallbacks: {spmd.DIST_FALLBACK_COUNTS}")
    log(f"dist groupby: [{gpu}] " + line)
    log(f"dist groupby: [{gpu}] {tbl.num_rows} rows -> {len(got)} groups with both keys "
        f"equal to phase 3's answer (keys and counts exact, sum/mean rtol 1e-5); warm "
        f"{warm_s * 1e3:.2f} ms over {mesh.size} shards against one in-memory "
        f"groupby_aggregate {mem_s * 1e3:.2f} ms (host clock, synchronized)")
    _dist_done(t0)


def dist_q3(gpu: str, li, filtered, want) -> None:
    """Collective 2: dist_join of Q3, both sides sharded: phase 5's 60M
    lineitem rows [l_orderkey, l_extendedprice] with the 7,289,153 filtered
    orders; every column equal to phase 5's oracle as a multiset, the
    probe kernel launched once for each shard."""
    from cudf_tpu_torch import join
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.parallel import spmd

    t0 = time.perf_counter()
    mesh = _dist_mesh()
    sl, sr = _dist_shard(li, mesh), _dist_shard(filtered, mesh)
    before = ht.probe_table.launches
    out, warm_s = _dist_run(mesh, lambda: spmd.dist_join(sl, sr, ["l_orderkey"],
                                                         ["o_orderkey"], "inner"))
    launches = ht.probe_table.launches - before
    line = _dist_line("dist join (output rows)", out.lengths, mesh, f"probe launches "
                      f"{launches} in the timed run and the warm one")
    first = launches // 2
    if first < sum(n > 0 for n in out.lengths):
        raise AssertionError(f"dist join: {first} probe launches a run for {mesh.size} shards")
    DIST["probe_launches"] += launches
    _, mem_s = synced(lambda: join(li, filtered, ["l_orderkey"], ["o_orderkey"], "inner",
                                   ordered=False))
    assert_rows(_columns(out.concat_to_table(), JOIN_COLS), want, "dist join", True)
    log(f"dist join: [{gpu}] " + line)
    log(f"dist join: [{gpu}] Q3's {li.num_rows} x {filtered.num_rows} rows -> "
        f"{sum(out.lengths)} rows equal to the oracle as a multiset, every column exact; "
        f"warm {warm_s * 1e3:.2f} ms over {mesh.size} shards against one in-memory join "
        f"{mem_s * 1e3:.2f} ms (host clock, synchronized)")
    _dist_done(t0)


def _bits_equal(a, b) -> bool:
    """Equal columns (floats by their bits, so NaN equals NaN)."""
    import torch

    if a.data.dtype.is_floating_point:
        return torch.equal(a.data.view(torch.int64 if a.data.element_size() == 8
                                       else torch.int32), b.data.view(
            torch.int64 if b.data.element_size() == 8 else torch.int32))
    return torch.equal(a.data, b.data)


def dist_sort(gpu: str, sort_tbl) -> None:
    """Collective 4: dist_sort_values of phase 8's 60M rows on [k1 f64 with
    2% NaN, k2 f32 descending]; row for row equal to sort_by_key with the
    same flags (every column's bits)."""
    from cudf_tpu_torch.ops.sorting import sort_by_key
    from cudf_tpu_torch.parallel import spmd

    t0 = time.perf_counter()
    mesh = _dist_mesh()
    st = _dist_shard(sort_tbl, mesh)
    flags = [False, True]
    out, warm_s = _dist_run(mesh, lambda: spmd.dist_sort_values(st, ["k1", "k2"], flags))
    line = _dist_line("dist sort", out.lengths, mesh, "no kernel of the port on this path")
    want, mem_s = synced(lambda: sort_by_key(sort_tbl, ["k1", "k2"], flags))
    got = out.concat_to_table()
    n = want.num_rows
    for c in ("k1", "k2", "v"):
        if got.num_rows != n or not _bits_equal(got[c].slice(0, n), want[c].slice(0, n)):
            raise AssertionError(f"dist sort: column {c} differs from sort_by_key")
    log(f"dist sort: [{gpu}] " + line)
    log(f"dist sort: [{gpu}] {n} rows on [k1, k2 descending] equal to sort_by_key row for "
        f"row, every column's bits; warm {warm_s * 1e3:.2f} ms over {mesh.size} shards "
        f"against one in-memory sort_by_key {mem_s * 1e3:.2f} ms (host clock, synchronized)")
    _dist_done(t0)


def _by_rid(tbl, names):
    """``tbl``'s ``names`` columns ordered by its row-id column."""
    import torch

    from cudf_tpu_torch.ops.copying import gather_table

    n = tbl.num_rows
    perm = torch.sort(tbl["rid"].data[:n], stable=True).indices
    return gather_table(tbl.select(names), perm, n)


def dist_tpch(gpu: str, dev: dict, plans: dict, runs: dict) -> None:
    """On phase 9's SF10 tables. Collective 3: broadcast_join of the 60M
    sharded lineitem rows with the 150,000-row supplier table on l_suppkey,
    and with a 3-row table on the string l_returnflag (its dictionary not
    lineitem's), each equal to the in-memory join row for row by a row id;
    then execute_spmd of q1, q3, q5 and q6 over 8 shards, each equal to
    IR.execute (keys and order exact, floats rtol 1e-6), and
    execute_streaming of q1 in target_partition_rows chunks."""
    from cudf_tpu_torch import Column, Table, join
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.parallel import actor_graph, spmd
    from cudf_tpu_torch.parallel.plan_executor import execute_spmd
    from cudf_tpu_torch.utils.options import get_option

    import torch

    t0 = time.perf_counter()
    mesh = _dist_mesh()
    li = dev["lineitem"]
    rid = Column(li["l_suppkey"].dtype, torch.arange(li["l_suppkey"].capacity,
                                                     device=li["l_suppkey"].device),
                 None, li.num_rows)
    base = Table({"rid": rid, **{c: li[c] for c in ("l_suppkey", "l_returnflag",
                                                    "l_extendedprice")}})
    st = _dist_shard(base, mesh)
    flags = Table.from_pandas(pd.DataFrame({"l_returnflag": ["R", "A", "Z"],
                                            "flag_w": [3.0, 1.0, 9.0]}), device=li.device)
    for what, small, lo, ro in (("int key", dev["supplier"], "l_suppkey", "s_suppkey"),
                                ("string key", flags, "l_returnflag", "l_returnflag")):
        before = ht.probe_table.launches
        out, warm_s = _dist_run(mesh, lambda: spmd.broadcast_join(st, small, [lo], [ro]))
        launches = ht.probe_table.launches - before
        DIST["probe_launches"] += launches
        line = _dist_line(f"dist broadcast join ({what}; output rows)", out.lengths, mesh,
                          f"probe launches {launches} (timed and warm runs)")
        want, mem_s = synced(lambda: join(base, small, [lo], [ro], "inner", ordered=False))
        got = out.concat_to_table()
        names = want.names
        if list(got.names) != names or got.num_rows != want.num_rows:
            raise AssertionError(f"dist broadcast join ({what}): {got.names} x "
                                 f"{got.num_rows} against {names} x {want.num_rows}")
        g, w = _by_rid(got, names), _by_rid(want, names)
        n = want.num_rows
        for c in names:
            if not _bits_equal(g[c].slice(0, n), w[c].slice(0, n)):
                raise AssertionError(f"dist broadcast join ({what}): column {c} differs")
        if what == "string key":
            # equal codes mean equal strings only under one dictionary
            if list(g["l_returnflag"].dictionary) != list(w["l_returnflag"].dictionary):
                raise AssertionError("dist broadcast join: the dictionaries differ")
        log(f"dist broadcast: [{gpu}] " + line)
        log(f"dist broadcast: [{gpu}] {li.num_rows} x {small.num_rows} rows on the {what} "
            f"-> {got.num_rows} rows equal to the in-memory join row for row (by row id); "
            f"warm {warm_s * 1e3:.2f} ms against one in-memory join {mem_s * 1e3:.2f} ms "
            f"(host clock, synchronized)")
    del st, base
    for q, plan in plans.items():
        before = ht.probe_table.launches
        mesh.reset_stats()
        got, first_s = synced(lambda: execute_spmd(plan, mesh).to_pandas())
        launches = ht.probe_table.launches - before
        DIST["probe_launches"] += launches
        _, warm_s = synced(lambda: execute_spmd(plan, mesh))
        pd.testing.assert_frame_equal(got, runs[q][0], rtol=1e-6)
        if q in ("q3", "q5") and launches < 1:
            raise AssertionError(f"execute_spmd {q}: the joins did not launch the probe")
        log(f"dist execute_spmd {q}: [{gpu}] {len(got)} rows equal to IR.execute's (keys, "
            f"counts and order exact, rtol 1e-6); first {first_s * 1e3:.2f} ms with "
            f"to_pandas, warm {warm_s * 1e3:.2f} ms against IR.execute's warm "
            f"{runs[q][2] * 1e3:.2f} ms (host clock, synchronized); {mesh.size} shards, "
            f"{mesh.stats.exchanges // 2} exchanges a run moving "
            f"{mesh.stats.exchange_bytes // 2} bytes; probe launches {launches} (first and "
            f"warm runs)")
    rows = get_option("target_partition_rows")
    got, first_s = synced(lambda: actor_graph.execute_streaming(plans["q1"]).to_pandas())
    pd.testing.assert_frame_equal(got, runs["q1"][0], rtol=1e-9)
    log(f"dist execute_streaming q1: [{gpu}] {li.num_rows} lineitem rows in chunks of "
        f"target_partition_rows = {rows} -> {len(got)} rows equal to IR.execute's (rtol "
        f"1e-9); {first_s * 1e3:.2f} ms with to_pandas (host clock)")
    if spmd.DIST_FALLBACK_COUNTS:
        raise AssertionError(f"dist fallbacks: {spmd.DIST_FALLBACK_COUNTS}")
    _dist_done(t0)


def _workers(argv, n: int, env_extra=None):
    """n worker processes of MP_SCRIPT joined through a TCPStore on a free
    port; returns their JSON results. A worker that fails or outlives
    MP_TIMEOUT_S fails the phase (every worker is stopped first)."""
    import socket

    repo = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(MP_SCRIPT)
        procs = []
        for r in range(n):
            env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get(
                "PYTHONPATH", ""), CUDF_TPU_COORDINATOR=f"127.0.0.1:{port}",
                CUDF_TPU_NUM_PROCESSES=str(n), CUDF_TPU_PROCESS_ID=str(r), **(env_extra or {}))
            procs.append(subprocess.Popen([sys.executable, script, *argv], cwd=repo, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MP_TIMEOUT_S) + (p.returncode,))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    results = []
    for r, (out, err, rc) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"dist worker {r} exited {rc}: {err[-3000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def dist_nccl(gpu: str, ranks: int) -> None:
    """dist_groupby and dist_sort_values of the README columns (MP_ROWS
    rows, a rank's rows every ranks-th) across ``ranks`` processes, one
    card each under NCCL: the groups equal pandas' (keys and counts exact,
    sums rtol 1e-5), the sort's ranks hold descending ranges in rank
    order."""
    t0 = time.perf_counter()
    res = _workers(["nccl", str(MP_ROWS)], ranks)
    got = pd.concat([pd.DataFrame(r["groups"]) for r in res])
    want = (lineitem(MP_ROWS, seed=0).astype({"l_extendedprice": np.float64})
            .groupby(KEYS, dropna=False)["l_extendedprice"].agg(["sum", "size"])
            .reset_index())
    got = got.sort_values(KEYS).reset_index(drop=True)
    want = want.sort_values(KEYS).reset_index(drop=True)
    np.testing.assert_array_equal(got[KEYS].to_numpy(float), want[KEYS].to_numpy(float))
    np.testing.assert_array_equal(got["n"].to_numpy(), want["size"].to_numpy())
    np.testing.assert_allclose(got["s"], want["sum"], rtol=1e-5)
    sorts = [r["sort"] for r in res]
    if sum(n for n, _, _, _ in sorts) != MP_ROWS or not all(ok for _, ok, _, _ in sorts):
        raise AssertionError("dist sort across ranks lost rows or left a rank unordered")
    bounds = [(first[0], last[0]) for n, _, first, last in sorts if n]
    if any(a[1] < b[0] for a, b in zip(bounds, bounds[1:])):
        raise AssertionError("dist sort across ranks: the ranks' ranges overlap")
    log(f"dist processes: [{gpu}] across {ranks} ranks (NCCL, one card each): "
        f"dist_groupby {len(got)} groups equal to pandas (keys and counts exact, sums rtol "
        f"1e-5), dist_sort_values {MP_ROWS} rows in descending ranges "
        f"{[n for n, _, _, _ in sorts]} a rank; {time.perf_counter() - t0:.1f} s (host "
        f"clock, process start included)")


def dist_processes(gpu: str) -> None:
    """Two processes sharing the card (the reference's two-ranks-one-GPU
    fixture): each runs execute_multiproc of q1 and q3 at SF1 (lineitem
    MP_ROWS rows) equal to its own IR.execute, and a host_exchange of
    packed lineitem halves. The cross-process mesh needs one card a rank
    under NCCL: with two or more cards, dist_groupby of the README query
    across 2 ranks against pandas; with one, it is not run."""
    import torch

    t0 = time.perf_counter()
    res = _workers(["gloo", str(MP_ROWS)], 2)
    for r in res:
        log(f"dist processes: [{gpu}] rank {r['rank']} of 2 on one card: execute_multiproc "
            f"q1 {r['q1']['rows']} rows warm {r['q1']['warm_ms']:.2f} ms, q3 "
            f"{r['q3']['rows']} rows warm {r['q3']['warm_ms']:.2f} ms, each equal to "
            f"IR.execute (rtol 1e-9, order exact); host_exchange of lineitem halves "
            f"({r['exchange_rows']} rows in) {r['exchange_s'] * 1e3:.1f} ms (host clock)")
    if torch.cuda.device_count() >= 2:
        dist_nccl(gpu, 2)
    else:
        log(f"dist processes: [{gpu}] the cross-process mesh (dist_groupby across 2 ranks) "
            f"not run: it needs one card a rank under NCCL, and this machine has "
            f"{torch.cuda.device_count()}")
    bad = [m for m in sys.modules if m in ("jax", "cudf_tpu")
           or m.startswith(("jax.", "cudf_tpu."))]
    if bad:
        raise AssertionError(f"dist: {bad[:5]} imported")
    log("dist: neither jax nor cudf_tpu is in sys.modules")
    _dist_done(t0)



# --------------------------------------------------------------- phase 17
# The wide-key phase runs inside phase 9, where the SF10 tables are alive:
# a two-key groupby on sparse 62-bit surrogate ids over rows of its own,
# and phase 9's lineitem grouped by l_extendedprice, a full-range f64 key.
# Both shapes fail the code-sort lanes' range plans and take the wide lane.
# pandas' answers take minutes at this size, so a process of their own
# (wide_oracles) computes them from the same seeds while phases 8 and 9 run.
WIDE = {"seconds": 0.0}
WIDE_ROWS = ROWS             # rows of the sparse-key shape
WIDE_POOL = 16               # distinct k2 ids (tenants)
WIDE_AGGS = ("mean", "sum", "count", "var", "min", "max", "first", "last")
WIDE_RUNS = 2                # warm runs a lane, taken in turns: wide, generic, generic, wide
WIDE_ORACLE_S = 900          # the oracle process not done by then fails the phase
WIDE_EXACT = {"k1", "k2", "count", "size", "min", "max", "first", "last",
              "l_extendedprice", "n"}
WIDE_ORACLE_SCRIPT = """\
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
cs.WIDE_ROWS, cs.ROWS = int(sys.argv[3]), int(sys.argv[4])
cs.wide_oracles(sys.argv[2])
"""


def wide_sparse_frame(n: int, seed: int = 17):
    """bench.py's sparse surrogate keys at n rows (bench.py:103,115-116):
    k1 drawn from np.unique of n // 20 random [0, 2^62) ints; k2 drawn from
    a pool of WIDE_POOL such ids, 1% null; v a seeded f64."""
    rng = np.random.default_rng(seed)
    dim = np.unique(rng.integers(0, 2**62, max(n // 20, 1), dtype=np.int64))
    pool = rng.integers(0, 2**62, WIDE_POOL, dtype=np.int64)
    return pd.DataFrame({
        "k1": dim[rng.integers(0, len(dim), n)],
        "k2": pd.arrays.IntegerArray(pool[rng.integers(0, WIDE_POOL, n)],
                                     rng.random(n) < 0.01),
        "v": rng.normal(size=n),
    })


def _values_and_nulls(series: pd.Series):
    """(values, null mask) of a pandas column, exact for a masked Int64
    column (whose to_numpy() rounds through f64); a float NaN is a null."""
    arr = series.array
    if isinstance(arr, pd.arrays.IntegerArray):
        return arr._data, arr._mask
    vals = series.to_numpy()
    return vals, np.isnan(vals) if vals.dtype.kind == "f" else np.zeros(len(vals), bool)


def wide_oracles(out_dir: str) -> None:
    """pandas' answers to phase 17's groupbys, from the phase's own seeds:
    every column's values and nulls written to ``out_dir`` as .npy files,
    then a file named ``done``. The sparse shape is answered with
    dropna=False; its dropna=True answer is the same without the null-k2
    groups."""
    def save(what, frame):
        for name in frame.columns:
            vals, nulls = _values_and_nulls(frame[name])
            np.save(os.path.join(out_dir, f"{what}.{name}.npy"), vals)
            np.save(os.path.join(out_dir, f"{what}.{name}.nulls.npy"), nulls)

    df = wide_sparse_frame(WIDE_ROWS)
    save("sparse", df.groupby(["k1", "k2"], sort=True, dropna=False).agg(
        **{k: ("v", k) for k in WIDE_AGGS}, size=("v", "size")).reset_index())
    del df
    li = gen_tables(ROWS)["lineitem"]
    save("price", li.groupby("l_extendedprice", sort=True).agg(
        q=("l_quantity", "sum"), d=("l_discount", "mean"),
        n=("l_quantity", "size")).reset_index())
    open(os.path.join(out_dir, "done"), "w").close()


def wide_oracle_start():
    """Start wide_oracles in a process of its own, in a temporary directory;
    the process is killed and the directory removed at exit."""
    import atexit
    import shutil

    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_wide_")
    proc = subprocess.Popen([sys.executable, "-c", WIDE_ORACLE_SCRIPT, repo, out_dir,
                             str(WIDE_ROWS), str(ROWS)], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)

    atexit.register(stop)
    return proc, out_dir, stop


def _wide_oracle(oracle, what: str, names) -> dict:
    """{column: (values, nulls)} of pandas' answer ``what``, once the
    oracle process is done (it fails the phase if it failed or is late)."""
    proc, out_dir, _ = oracle
    if not os.path.exists(os.path.join(out_dir, "done")):
        _, err = proc.communicate(timeout=WIDE_ORACLE_S)
        if proc.returncode != 0 or not os.path.exists(os.path.join(out_dir, "done")):
            raise AssertionError(f"wide: the pandas oracle process exited "
                                 f"{proc.returncode}: {err[-3000:]}")
    return {n: (np.load(os.path.join(out_dir, f"{what}.{n}.npy")),
                np.load(os.path.join(out_dir, f"{what}.{n}.nulls.npy"))) for n in names}


def _host_columns(tbl) -> dict:
    """{column: (values, nulls)} of a port Table on the host, without
    to_pandas's object columns; a float NaN is a null, as in pandas."""
    out = {}
    for name, c in tbl:
        vals = c.data[:c.length].cpu().numpy()
        nulls = np.zeros(c.length, bool) if c.validity is None else \
            ~c.validity[:c.length].cpu().numpy()
        if vals.dtype.kind == "f":
            nulls |= np.isnan(vals)
        out[name] = (vals, nulls)
    return out


def _wide_equal(what: str, got: dict, want: dict) -> None:
    """Row for row: the WIDE_EXACT columns (keys, counts, first/last,
    min/max) equal with nulls in the same rows, the others within rtol
    1e-6."""
    if list(got) != list(want) or len(got[next(iter(got))][0]) != len(want[next(iter(want))][0]):
        raise AssertionError(f"wide {what}: columns or rows differ from pandas'")
    for name, (w, wn) in want.items():
        g, gn = got[name]
        if not np.array_equal(gn, wn):
            raise AssertionError(f"wide {what}: {name}'s nulls differ from pandas'")
        if name in WIDE_EXACT:
            if not np.array_equal(g[~gn], w[~wn]):
                raise AssertionError(f"wide {what}: {name} differs from pandas'")
        else:
            np.testing.assert_allclose(g[~gn], w[~wn], rtol=1e-6, atol=1e-8,
                                       err_msg=f"wide {what}: {name}")


def _wide_lanes(gpu: str, what: str, tbl, keys, aggs, dropna: bool) -> str:
    """Warm times of the wide lane and the generic engine on one input, in
    turns (wide, generic, generic, wide), and each one's device breakdown."""
    import torch

    from cudf_tpu_torch.ops.groupby import generic_groupby
    from cudf_tpu_torch.ops.widegroup import wide_groupby

    lanes = {"wide": lambda: wide_groupby(tbl, keys, aggs, dropna),
             "generic": lambda: generic_groupby(tbl, keys, aggs, dropna)}
    times = {"wide": [], "generic": []}
    for name in ["wide", "generic", "generic", "wide"] * (WIDE_RUNS // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lanes[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    line = ", ".join(f"{n} {' / '.join(f'{t:.2f}' for t in ts)} ms"
                     for n, ts in times.items())
    log(f"wide {what}: [{gpu}] warm, host clock ending in a synchronize: {line}")
    for name, fn in lanes.items():
        log(f"wide {what}: [{gpu}] {name} lane device breakdown: " + device_breakdown(fn))
    return f"{what} wide {min(times['wide']):.2f} ms, generic {min(times['generic']):.2f} ms"


def _wide_first(gpu: str, what: str, tbl, keys, aggs, dropna: bool):
    """groupby_aggregate's first call (synchronized) and its answer on the host."""
    import torch

    from cudf_tpu_torch.ops.groupby import groupby_aggregate

    t0 = time.perf_counter()
    out = groupby_aggregate(tbl, keys, aggs, dropna_keys=dropna)
    torch.cuda.synchronize()
    log(f"wide {what}: [{gpu}] groupby_aggregate(dropna_keys={dropna}) "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (first, host clock), "
        f"{out.num_rows} groups")
    return _host_columns(out)


def wide_phase(gpu: str, dev: dict, oracle) -> None:
    """Phase 17 on phase 9's SF10 tables. (a) The groupby [k1, k2] of
    WIDE_ROWS rows of sparse 62-bit ids (wide_sparse_frame) with mean, sum,
    count, var, min, max, first, last and size of v, with dropna_keys True
    and False; (b) lineitem grouped by l_extendedprice with sum(l_quantity),
    mean(l_discount) and size. Each through groupby_aggregate against
    pandas' answer from the oracle process (keys, order and counts exact,
    floats rtol 1e-6), the wide lane's counter up once a call and neither
    kernel launched; then the warm times of the wide lane and the generic
    engine on the same input."""
    import torch

    from cudf_tpu_torch import Table
    from cudf_tpu_torch.kernels import hashtable as ht
    from cudf_tpu_torch.kernels import onehot_groupby as oh
    from cudf_tpu_torch.ops.groupby import AggSpec
    from cudf_tpu_torch.ops.widegroup import wide_groupby

    t_phase = time.perf_counter()
    kernels0 = (ht.probe_table.launches, oh.groupby_sum_count.launches)
    wide0 = wide_groupby.launches
    t0 = time.perf_counter()
    df = wide_sparse_frame(WIDE_ROWS)
    tbl = Table.from_pandas(df)
    torch.cuda.synchronize()
    log(f"wide sparse: [{gpu}] {WIDE_ROWS} rows of k1 (62-bit ids, {WIDE_ROWS // 20} drawn), "
        f"k2 ({WIDE_POOL} ids, {int(df['k2'].isna().sum())} null) and v, generated and "
        f"ingested in {time.perf_counter() - t0:.1f} s (host clock)")
    del df
    keys = ["k1", "k2"]
    aggs = [AggSpec("v", k, k) for k in WIDE_AGGS] + [AggSpec("", "size", "size")]
    got = {dropna: _wide_first(gpu, "sparse", tbl, keys, aggs, dropna)
           for dropna in (True, False)}
    sparse = _wide_lanes(gpu, "sparse", tbl, keys, aggs, True)
    del tbl
    torch.cuda.empty_cache()

    keys = ["l_extendedprice"]
    aggs = [AggSpec("l_quantity", "sum", "q"), AggSpec("l_discount", "mean", "d"),
            AggSpec("", "size", "n")]
    price_got = _wide_first(gpu, "price", dev["lineitem"], keys, aggs, True)
    price = _wide_lanes(gpu, "price", dev["lineitem"], keys, aggs, True)
    answered = wide_groupby.launches - wide0
    calls = 3 + 2 * (WIDE_RUNS + 1)  # groupby_aggregate, then a shape's timed runs and profile
    if answered != calls:
        raise AssertionError(f"wide: the wide lane answered {answered} of {calls} calls")
    if (ht.probe_table.launches, oh.groupby_sum_count.launches) != kernels0:
        raise AssertionError("wide: a groupby of the phase launched a kernel")

    t0 = time.perf_counter()
    want = _wide_oracle(oracle, "sparse", got[False])
    waited = time.perf_counter() - t0
    _wide_equal("sparse dropna=False", got[False], want)
    keep = ~want["k2"][1]
    _wide_equal("sparse dropna=True", got[True], {n: (v[keep], m[keep])
                                                  for n, (v, m) in want.items()})
    _wide_equal("price", price_got, _wide_oracle(oracle, "price", price_got))
    oracle[2]()
    log(f"wide: both shapes equal pandas (keys, order, counts, first/last/min/max exact, "
        f"floats rtol 1e-6), the sparse one both ways; waited {waited:.1f} s for the "
        f"oracle process, checks {time.perf_counter() - t0 - waited:.1f} s (host clock)")
    WIDE["seconds"] += time.perf_counter() - t_phase
    log(f"wide: [{gpu}] best warm times: {sparse}; {price}; the wide lane answered "
        f"{answered} calls (3 through groupby_aggregate); probe and one-hot launches 0")


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
    warm = cudf_tpu_torch.prewarm(ROWS)  # in a thread, beside the data's generation
    df = lineitem(ROWS, seed=0)
    log(f"data: [{gpu}] {ROWS} lineitem rows generated in "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    warm.join()
    log(f"prewarm: [{gpu}] cudf_tpu_torch.prewarm({ROWS}) in a thread: the kernels built "
        f"and the sort lane and scans warmed at 2^26 and 2^27 rows, joined "
        f"{time.perf_counter() - t0:.1f} s after its start (host clock)")
    n_active = int(df[KEYS].notna().all(axis=1).sum())
    from cudf_tpu_torch.utils.padding import bucket_capacity

    onehot = kernels_vs_plain(gpu, bucket_capacity(n_active), n_active)
    segred = segment_reduce_vs_plain(gpu)
    torch.cuda.empty_cache()
    segred["h2o_launches"] = segment_reduce_h2o(gpu)
    dense = dense_groupby_vs_plain(gpu)
    torch.cuda.empty_cache()
    tbl, onehot["launches"], readme_out = main_path(gpu, df)
    dist_readme(gpu, tbl, readme_out)
    nested_intervals(gpu, tbl, df)
    nested_sketches(gpu, tbl, df)
    nested_pack(gpu, tbl)
    nested_hashes(gpu, df)
    decimal_ops(gpu, tbl, df)
    frame, onehot["frame_launches"], frame_s = frame_readme(gpu, df)
    frame_s += frame_series(gpu, df, frame)
    accel_readme(gpu, df, frame)
    del frame
    segred["launches"] = sort_lane(gpu, tbl, df)
    nested_collect(gpu, df)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc_") as tmp:
        onehot["ooc_launches"], ooc_budget, ooc_s = ooc_readme(gpu, df, tbl, readme_out,
                                                               tmp)
    ooc_s += ooc_compaction(gpu, tbl)
    del tbl
    t0 = time.perf_counter()
    od = orders(ORDERS, seed=1)
    want, match = join_oracle(df, od)
    log(f"data: [{gpu}] {ORDERS} orders and the numpy join oracle in "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    t0 = time.perf_counter()
    li, filtered, probe_launches, builds = join_path(gpu, df, od, want, match)
    merge_launches, merge_s = frame_merge(gpu, li, filtered, want)
    frame_s += merge_s
    accel_merge(gpu, df, od, want)
    decimal_join(gpu, li, filtered, want)
    nested_bloom(gpu, li, filtered, match)
    dist_q3(gpu, li, filtered, want)
    t1 = time.perf_counter()
    ooc_join_launches, join_s = ooc_join(gpu, li, filtered, want, ooc_budget)
    ooc_s += join_s
    t1b = time.perf_counter()
    join_general(gpu, li, filtered, want, match)
    t2 = time.perf_counter()
    probe = probe_vs_plain(gpu, li, filtered)
    insert = insert_vs_plain(gpu)
    t3 = time.perf_counter()
    log(f"phases: [{gpu}] join {t1 - t0:.1f} s, join-general {t2 - t1b:.1f} s, probe "
        f"kernel checks {t3 - t2:.1f} s (host clock, checks included)")
    probe["launches"] = probe_launches
    insert["launches"] = builds  # the first Q3 join's builds: the main path
    probe["frame_launches"] = merge_launches
    del df, od, want, match, li, filtered  # the README and join frames
    torch.cuda.empty_cache()
    wide_oracle = wide_oracle_start()  # pandas' answers for phase 17, beside phases 8 and 9
    sort_tbl, sorted_cols = sort_phase(gpu)
    dist_sort(gpu, sort_tbl)
    t4 = time.perf_counter()
    ooc_s += ooc_sort(gpu, sort_tbl, sorted_cols)
    del sort_tbl, sorted_cols
    torch.cuda.empty_cache()
    t4b = time.perf_counter()
    (probe["tpch_launches"], host, q3_out, tpch_ooc_launches, tpch_ooc_s,
     dense_tpch) = tpch_phase(gpu, wide_oracle)
    dense["launches"] = sum(dense_tpch.values())  # the queries' first runs: the main path
    dense["tpch_launches"] = dense_tpch
    probe["ooc_launches"] = ooc_join_launches + tpch_ooc_launches
    ooc_s += tpch_ooc_s
    t5 = time.perf_counter()
    strings_phase(gpu)
    t6 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as tmp:
        probe["io_launches"], scan_s = io_phase(gpu, host, q3_out, tmp)
        accel_runner(gpu, tmp)
    prewarm_first_call(gpu)
    dist_processes(gpu)
    frame_s += scan_s
    del host
    accel_battery(gpu)
    log(f"phases: [{gpu}] sort {t4 - t3:.1f} s, tpch "
        f"{t5 - t4b - tpch_ooc_s - WIDE['seconds']:.1f} s, "
        f"strings {t6 - t5:.1f} s, io {time.perf_counter() - t6:.1f} s (host clock, data "
        f"and oracles included)")
    log(f"phases: [{gpu}] frame {frame_s:.1f} s (host clock, oracles included: the "
        f"README quick start and Series ops, the merge, the frame over parquet)")
    log(f"phases: [{gpu}] out-of-core {ooc_s:.1f} s (host clock, writes and checks "
        f"included: the streamed README groupby, the chunked compaction, the partitioned "
        f"Q3 join, the out-of-core and chunked sorts, the chunked groupby and the "
        f"partitioned TPC-H); probe launches {probe['ooc_launches']}, one-hot launches "
        f"{onehot['ooc_launches']}")
    onehot["nested_launches"] = NESTED["onehot_launches"]
    probe["nested_launches"] = NESTED["probe_launches"]
    log(f"phases: [{gpu}] nested and long tail {NESTED['seconds']:.1f} s (host clock, data, "
        f"oracles and checks included: intervals, sketches, pack and hashes on phase 3's "
        f"rows, COLLECT_LIST, the bloom filter, the joins with a predicate, the lists from "
        f"strings, S3 and avro); one-hot launches {NESTED['onehot_launches']} (the cut "
        f"groupbys), probe launches {NESTED['probe_launches']} (mixed_join and the token "
        f"merge)")
    onehot["accel_launches"] = ACCEL["onehot_launches"]
    probe["accel_launches"] = ACCEL["probe_launches"]
    log(f"phases: [{gpu}] accelerator and decimals {ACCEL['seconds']:.1f} s (host clock, "
        f"data, oracles and checks included: the quick start and the merge through the "
        f"accelerator, the runner, the battery, the decimal64 and decimal128 ops, their "
        f"groupby and join); one-hot launches {ACCEL['onehot_launches']} (the quick start "
        f"and groupby(l_discount)), probe launches {ACCEL['probe_launches']} (P.merge and "
        f"the decimal64 join)")
    onehot["dist_launches"] = DIST["onehot_launches"]
    probe["dist_launches"] = DIST["probe_launches"]
    log(f"phases: [{gpu}] distributed {DIST['seconds']:.1f} s (host clock, data, in-memory "
        f"twins and checks included: dist_groupby of the README query, the Q3 dist_join, "
        f"dist_sort_values, the broadcast joins, execute_spmd of q1/q3/q5/q6, "
        f"execute_streaming of q1, two processes sharing the card); one-hot launches "
        f"{DIST['onehot_launches']} (the shards' groupbys), probe launches "
        f"{DIST['probe_launches']} (the shards' joins)")
    log(f"phases: [{gpu}] wide keys {WIDE['seconds']:.1f} s (host clock, data, pandas "
        f"oracles and checks included: the sparse two-key groupby both ways, lineitem by "
        f"l_extendedprice, each lane's warm times and profiles)")
    from cudf_tpu_torch.kernels import segment_reduce as sr

    if sr.contract_broken():
        raise AssertionError("a segment_reduce call on the card passed ids out of order or "
                             "out of range")
    log("kernels: every segment_reduce launch since phase 2 kept the contract (ids "
        "non-decreasing, in range)")
    log(f"total: [{gpu}] {time.perf_counter() - t_start:.1f} s (host clock)")
    log(gpu)
    log(json.dumps({"kernels": [onehot, probe, check, segred, dense, insert]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
