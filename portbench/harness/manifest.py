"""``BENCHMARK.json`` and the files that its names lead to.

Everything that belongs to one configuration, traffic mix or metric sits
in files of its own, found by name, so that a cell, a configuration or a
metric is added with new files and entries only:

- ``configs/<config>.json``: the deployment (source, sizes, schema,
  guarantees, operations and the limits of the comparison), and
  ``configs/<config>.py`` beside it: the generator, the port's state and
  the operations;
- ``reference/<config>.py``: the plain reference;
- ``traffic/<mix>.json``: the operations of a mix and their order;
- ``metrics/<metric>.py``: the reader of one metric.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # portbench/
ROOT = HERE.parent                                  # the checkout
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def spec(manifest: dict, config: str) -> dict:
    """The configuration's JSON file, as ``BENCHMARK.json`` names it."""
    with open(ROOT / config_entry(manifest, config)["file"]) as f:
        return json.load(f)


def resize(spec: dict, sizes: dict | None) -> dict:
    """``spec`` with its sizes overridden: ``sizes["tables"]`` maps a table
    to its row count; any other key replaces the dict of that name's
    entries (such as a generator's counts)."""
    for key, value in (sizes or {}).items():
        if key == "tables":
            for t, rows in value.items():
                spec["tables"][t]["rows"] = rows
        else:
            spec[key] = {**spec[key], **value}
    return spec


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module; a name may hold ``.``
    and ``-``, so it is loaded by path, not imported by name."""
    mod_name = f"portbench_{kind}_{name}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        path = HERE / kind / f"{name}.py"
        if not path.exists():
            raise FileNotFoundError(f"{kind} {name!r}: no {path.relative_to(ROOT)}")
        spec_ = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec_)
        sys.modules[mod_name] = mod
        spec_.loader.exec_module(mod)
    return mod


def config_module(name: str):
    return _module("configs", name)


def reference_module(name: str):
    return _module("reference", name)


def metric_module(name: str):
    return _module("metrics", name)


def applies(metric: dict, workload: dict, manifest: dict) -> bool:
    """Whether ``workload`` reports ``metric``: the cells its ``workloads``
    key lists; without one, every cell that reports the end-to-end metric
    it moves (or, for an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return workload["name"] in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    return applies(e2e[moves], workload, manifest)


def metrics_of(manifest: dict, workload: dict, traced: bool) -> list:
    """The metrics a run of ``workload`` prints: the end-to-end ones
    untraced, the per-layer ones traced."""
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in group if applies(m, workload, manifest)]
