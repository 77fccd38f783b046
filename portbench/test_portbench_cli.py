"""The command as the driver runs it, and a configuration, a traffic mix
and a metric added as files alone."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ARGS = ["--workload", "tpch_sf30.joins", "--seed", str(2**33 + 1), "--seconds", "1",
        "--trace", "0"]
# torch told that a card is there, to get past the command's look for one
FAKE_CARD = ("import runpy, sys, torch; torch.cuda.is_available = lambda: True; "
             "torch.cuda.device_count = lambda: 1; sys.argv = ['portbench/run.py'] + {args!r}; "
             "runpy.run_path('portbench/run.py', run_name='__main__')")


def _copy(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*", "conftest.py"))
    return tmp_path


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout)
    assert "no result" in p.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    root = _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", FAKE_CARD.format(args=ARGS)], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout, p.stderr[-2000:])


def test_a_cell_added_as_files_alone(tmp_path):
    """A configuration (its JSON, module and reference), a traffic mix and
    a per-layer metric dropped in as new files, with entries in
    BENCHMARK.json, run with no edit to any file that was there."""
    root = _copy(tmp_path)
    pb = root / "portbench"
    spec = json.loads((pb / "configs" / "tpch_sf30.json").read_text())
    spec["name"] = "tpch_drop"
    spec["dbgen"] = {"orders": 500, "customers": 60, "suppliers": 8, "parts": 100}
    for t, rows in {"lineitem": 2000, "orders": 500, "customer": 60, "supplier": 8}.items():
        spec["tables"][t]["rows"] = rows
    (pb / "configs" / "tpch_drop.json").write_text(json.dumps(spec))
    shutil.copy(pb / "configs" / "tpch_sf30.py", pb / "configs" / "tpch_drop.py")
    shutil.copy(pb / "reference" / "tpch_sf30.py", pb / "reference" / "tpch_drop.py")
    (pb / "traffic" / "q6_q3.json").write_text(json.dumps(
        {"operations": {"q6": 2, "q3": 1}, "trace_blocks": 1}))
    (pb / "metrics" / "ops_traced.py").write_text(
        "def read(ctx):\n    return len(ctx.latencies) if ctx.trace else None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tpch_drop", "source": "https://www.tpc.org",
                         "file": "portbench/configs/tpch_drop.json", "reduced": [],
                         "why": "a drop-in"})
    m["workloads"].append({"name": "tpch_drop.q6_q3", "config": "tpch_drop",
                           "traffic": "q6_q3", "chips": 1, "why": "a drop-in"})
    m["per_layer"].append({"name": "ops_traced", "unit": "ops", "better": "higher",
                           "source": "host_clock", "layer": "device", "moves": "rows_per_s",
                           "workloads": ["tpch_drop.q6_q3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    script = ("import json, sys; sys.path[:0] = [{root!r}, {repo!r}]; "
              "from portbench.harness import cell; "
              "print(json.dumps(cell.run('tpch_drop.q6_q3', 11, 0.2, True, 'cpu')))"
              ).format(root=str(root), repo=str(ROOT))
    p = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["ops_traced"]["value"] == 3


@pytest.mark.cuda
def test_each_cell_on_the_card():
    """A short run of every cell on the card, untraced and traced: correct,
    and every metric of the cell reported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs nowhere else")
    from portbench.harness import manifest as mf

    m = mf.load()
    for w in m["workloads"]:
        for traced in (0, 1):
            p = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                                "--seed", "5", "--seconds", "3", "--trace", str(traced)],
                               cwd=ROOT, capture_output=True, text=True, timeout=900)
            assert p.returncode == 0, p.stderr[-3000:]
            out = json.loads(p.stdout.strip().splitlines()[-1])
            assert out["correct"], out
            want = {x["name"] for x in mf.metrics_of(m, w, bool(traced))}
            assert set(out["metrics"]) == want
