"""Time the code-sort groupby lanes of several checkouts on one card.

    python3 sort_lane_ab.py DIR [DIR ...]

Each DIR is the root of a checkout of this repo (``.`` for this one). Give
the checkouts in the order A B B A: each runs in a process of its own, one
after the other, so that a drift of the card over the call shows up in both.
A process builds chip_smoke.py's data (its ``lineitem`` at ROWS rows) with
the checkout's own code and times, warm, with the host clock ending in a
synchronize:

  - ``groupby``: chip_smoke.py's phase 4 query, groupby_aggregate of the
    first CUT_ROWS rows by l_orderkey with sum/mean/min/max/var (groups of
    about four rows);
  - ``keys.groupby``: the same aggregates of all ROWS rows by
    [l_returnflag, l_linestatus] (four groups of millions of rows);
  - ``a.sort_groupby`` and ``b.sort_groupby``: argmin and argmax of
    l_extendedprice through ``sortgroup.sort_groupby`` called directly, at
    chip_smoke.py's arg_lanes shapes: (a) those CUT_ROWS rows by
    l_orderkey, (b) all ROWS rows by [l_returnflag, l_linestatus].

Each timing is taken RUNS times, the lanes in turns, and reported whole.
The process also takes one torch.profiler table of each call: every
kernel's name, launch count and device time. The tables go to
``chiprun_out/sort_lane_ab.json``; standard output gets one JSON line a
checkout, the card's name and power limit, and a summary of the best times.
Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

RUNS = 6
CHILD_TIMEOUT_S = 600


def _child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from cudf_tpu_torch import AggSpec, Column, Table, groupby_aggregate
    from cudf_tpu_torch.ops import sortgroup

    df = cs.lineitem(cs.ROWS, seed=0)
    tbl = Table.from_pandas(df[cs.KEYS + ["l_extendedprice"]])
    cut = Table({"l_orderkey": Column.from_numpy(df["l_orderkey"].to_numpy()[:cs.CUT_ROWS]),
                 "l_extendedprice": tbl["l_extendedprice"].slice(0, cs.CUT_ROWS)})
    del df
    sums = [AggSpec("l_extendedprice", k, k) for k in ("sum", "mean", "min", "max", "var")]
    args = [AggSpec("l_extendedprice", k, k) for k in ("argmin", "argmax")]
    calls = {"groupby": lambda: groupby_aggregate(cut, ["l_orderkey"], sums),
             "keys.groupby": lambda: groupby_aggregate(tbl, cs.KEYS, sums)}
    for shape, t, keys in (("a", cut, ["l_orderkey"]), ("b", tbl, cs.KEYS)):
        calls[f"{shape}.sort_groupby"] = (
            lambda t=t, k=keys: sortgroup.sort_groupby(t, k, args, True))
    for fn in calls.values():
        fn()  # warm: stats cached, kernels and allocations made
    times = {n: [] for n in calls}
    order = list(calls)
    for r in range(RUNS):
        for name in order if r % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    kernels = {}
    for name in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            calls[name]()
            torch.cuda.synchronize()
        kernels[name] = sorted(
            ([e.key, e.count, e.self_device_time_total / 1e3] for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
             and not getattr(e, "is_user_annotation", False)),
            key=lambda k: -k[2])
    return {"root": root, "times_ms": times, "kernels_ms": kernels}


def main(roots) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sort_lane_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    results = []
    for root in roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                            os.path.abspath(root)], capture_output=True, text=True,
                           timeout=CHILD_TIMEOUT_S)
        if p.returncode != 0:
            print(p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"sort_lane_ab: the process for {root} exited {p.returncode}")
        res = json.loads(p.stdout.strip().splitlines()[-1])
        results.append(res)
        print(json.dumps({"root": root, "times_ms": res["times_ms"]}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "sort_lane_ab.json"), "w") as f:
        json.dump({"card": card, "results": results}, f, indent=1)
    print(card)
    for i, res in enumerate(results):
        best = {n: round(min(ts), 3) for n, ts in res["times_ms"].items()}
        busy = {n: round(sum(k[2] for k in ks), 3) for n, ks in res["kernels_ms"].items()}
        print(f"{i} {res['root']}: best of {RUNS} ms {best}; kernels ms {busy}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(_child(sys.argv[2])))
    else:
        sys.exit(main(sys.argv[1:] or ["."]))
