"""BENCHMARK.json against the contract's form, and every name it holds
leading to the files of its own."""
import json

import pytest

from portbench.harness import manifest as mf

M = mf.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(M) == KEYS
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert len(json.dumps(M)) <= 64 * 1024
    assert len(M["command"]) <= 32 and M["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])


def test_names_units_and_texts():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in M["workloads"]]:
        assert mf.NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert mf.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in mf.SOURCES
    for text in ([w["why"] for w in M["workloads"]] + [c["why"] for c in M["configs"]]
                 + [c["source"] for c in M["configs"]] + [m["layer"] for m in M["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_only_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_moves_and_workloads_agree():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"]: w for w in M["workloads"]}
    assert "setup_s" in e2e
    for m in M["per_layer"] + M["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in cells, (m["name"], w)
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert mf.applies(e2e[m["moves"]], cells[w], M), (m["name"], w)
    for w in cells.values():
        reported = {m["name"] for m in mf.metrics_of(M, w, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert mf.metrics_of(M, w, True)


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_every_cell_finds_its_files_by_name(w):
    work = mf.cell(M, w)
    spec = mf.spec(M, work["config"])
    cfg = mf.config_module(work["config"])
    mix = mf.traffic(work["traffic"])
    assert set(mix["operations"]) <= set(cfg.OPERATIONS) <= set(spec["operations"])
    assert hasattr(mf.reference_module(work["config"]), "answers")
    for traced in (False, True):
        for m in mf.metrics_of(M, work, traced):
            assert callable(mf.metric_module(m["name"]).read)


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("portbench/")
        spec = mf.spec(M, c["name"])
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
        assert set(spec["checks"]) == {"mismatches", "max_rel_err"}
