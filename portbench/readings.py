"""The readings that the limits of the comparison are set from.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out chiprun_out/readings.json]

For each seed of ``--seeds``: the cell's data at its own size, ``ROUNDS``
blocks of its mix run through the port as a run's window runs them, each
execution with parameters drawn from the seed as a run draws them, and
the comparison's numbers against the reference (the lower readings), with
each hash table that the joins built. For each seed of
``--control-seeds``: the same executions answered by the control, the
reference with its values rounded to the configuration's
``control_precision`` (each row's arithmetic in it, the sums in float64),
put in the program's place and held against the reference (the upper
readings). The benchmark's own runs do not run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 3


def _free(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _counting_builds(builds: list):
    """``kernels.hashtable.build_table`` wrapped to append (build rows,
    table slots, all placed) to ``builds`` for each call: a join whose
    table is built again at twice the size shows as a call not placed."""
    from cudf_tpu_torch.kernels import hashtable as ht

    build = ht.build_table

    def counted(k1, k2, valid, m):
        out = build(k1, k2, valid, m)
        builds.append((int(valid.sum()), m, bool(out[3])))
        return out

    ht.build_table = counted
    return lambda: setattr(ht, "build_table", build)


def program_reading(work, spec, seed, device) -> dict:
    """The comparison's numbers for one seed of the program, with the hash
    builds of its joins (``builds``: build rows, slots, all placed)."""
    import torch

    from portbench.harness import compare, manifest as mf
    from portbench.harness.cell import quiet_span

    cfg = mf.config_module(work["config"])
    runs = _executions(work, cfg, seed)
    state = cfg.build(cfg.generate(spec, seed, device), spec, {op for op, _ in runs}, device)
    builds = []
    restore = _counting_builds(builds)
    try:
        results = [(op, p, cfg.OPERATIONS[op](state, quiet_span, p)) for op, p in runs]
    finally:
        restore()
    del state
    _free(device)
    raw = cfg.generate(spec, seed, device)
    want = mf.reference_module(work["config"]).answers(
        raw, spec, runs, getattr(torch, spec["precision"]))
    reading = {"mismatches": 0, "max_rel_err": 0.0}
    for op, p, out in results:
        reading = compare.merge(reading, compare.compare(out, want[(op, p)][0]))
    return {**reading, "builds": builds}


def _executions(work, cfg, seed) -> list:
    """(operation, parameters) of ``ROUNDS`` blocks of the mix, drawn from
    the seed as a run's window draws them."""
    from portbench.harness import manifest as mf, traffic
    from portbench.harness.cell import parameters

    mix = mf.traffic(work["traffic"])
    seq, draw = traffic.sequence(mix, seed), parameters(cfg, seed, 1)
    return [(op, draw(op)) for op in (next(seq) for _ in range(ROUNDS * len(traffic.block(mix))))]


def control_reading(work, spec, seed, device) -> dict:
    """The comparison's numbers for the reference in the control precision."""
    import pandas as pd
    import torch

    from portbench.harness import compare, manifest as mf

    cfg = mf.config_module(work["config"])
    ref = mf.reference_module(work["config"])
    runs = _executions(work, cfg, seed)
    raw = cfg.generate(spec, seed, device)
    want = ref.answers(raw, spec, runs, getattr(torch, spec["precision"]))
    low = ref.answers(raw, spec, runs, getattr(torch, spec["control_precision"]))
    reading = {"mismatches": 0, "max_rel_err": 0.0}
    for key in want:
        reading = compare.merge(reading, compare.compare(pd.DataFrame(low[key][0]),
                                                         want[key][0]))
    return reading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)

    from portbench.harness import manifest as mf

    m = mf.load()
    work = mf.cell(m, args.workload)
    spec = mf.spec(m, work["config"])
    out = {"workload": args.workload, "program": {}, "control": {}}
    for kind, seeds, fn in (("program", args.seeds, program_reading),
                            ("control", args.control_seeds, control_reading)):
        for s in filter(None, seeds.split(",")):
            t0 = time.perf_counter()
            r = fn(work, spec, int(s), args.device)
            out[kind][s] = r
            print(f"{args.workload} {kind} seed {s}: {json.dumps(r)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            _free(args.device)
    rebuilt = [s for s, r in out["program"].items() if not all(b[2] for b in r["builds"])]
    if out["program"]:
        print(f"{args.workload} program: a hash table built again on seeds {rebuilt}",
              flush=True)
    for kind in ("program", "control"):
        if out[kind]:
            rel = [r["max_rel_err"] for r in out[kind].values()]
            mis = [r["mismatches"] for r in out[kind].values()]
            print(f"{args.workload} {kind}: max_rel_err {min(rel)!r} .. {max(rel)!r}, "
                  f"mismatches {min(mis)} .. {max(mis)} over {len(rel)} seeds", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
