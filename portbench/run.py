"""Run one cell of BENCHMARK.json on one NVIDIA GPU and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number the
comparison with the reference judged, beside its limit); the same numbers
are the last lines on standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits 2; a run that loads
JAX or the JAX package exits 3.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402

# one process with one host thread for each pool: the card's work is
# driven from the main thread, and idle pool threads spinning beside it on
# a shared host only add to the spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power limit not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else sys.float_info.max


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.harness import cell, manifest

    work = manifest.cell(manifest.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        _log(f"no result: the cell needs {work['chips']} NVIDIA GPU(s), "
             f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import importlib.util

    found = importlib.util.find_spec("cudf_tpu_torch")
    if found is None or not Path(found.origin).resolve().is_relative_to(ROOT):
        _log("no result: cudf_tpu_torch is not in this checkout")
        return 2
    try:
        out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       t_start=T0)
    except cell.Refused as e:
        _log(f"no result: {e}")
        return 3
    # after the window, so that nvidia-smi is not counted in setup_s
    _log(f"card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, c in out["checks"].items():
        c["value"] = _finite(c["value"])
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not portbench/: its packages by their own names
    sys.exit(main())
