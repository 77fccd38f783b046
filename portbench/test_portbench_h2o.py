"""The db-benchmark groupby cell (``h2o_g1_1e8.questions``) at a tiny
seeded size on the CPU: its reference against pandas, the port against the
reference through a run, the control and the faults that the comparison
must catch, and the readers of its two new ranges on hand-built traces.

The cell also joins the tests of ``test_portbench_cells.py`` that run over
every cell: its tiny size goes into ``conftest.TINY`` and its faults into
that file's ``_faults`` when this module is collected beside them (their
files are the benchmark's and are not edited here).
"""
import pandas as pd
import pytest
import torch

from portbench import conftest, readings
from portbench.harness import cell, compare, manifest as mf
from portbench.harness.trace import Trace

M = mf.load()
CELL, CONFIG = "h2o_g1_1e8.questions", "h2o_g1_1e8"
H2O_TINY = {"tables": {"x": 20000}, "datagen": {"K": 10}}
SEED = 2**31 + 12345
MS = 1_000_000  # ns


def _spec(data_seed=0):
    spec = mf.resize(mf.spec(M, CONFIG), H2O_TINY)
    spec["data_seed"] = data_seed
    return spec


def _altered(fn):
    """``fn`` with the float values of its result's columns altered by 1e-3."""
    def wrapper(*a, **k):
        from cudf_tpu_torch import Column, Table

        out = fn(*a, **k)
        if isinstance(out, Column):
            return Column(out.dtype, out.data * (1 + 1e-3), out.validity, out.length)
        return Table({n: Column(c.dtype, c.data * (1 + 1e-3), c.validity, c.length,
                                c.dictionary) if c.dtype.is_floating else c for n, c in out})
    return wrapper


def _faults():
    """One fault a question, each with a seed whose first execution is that
    question (a window runs at least one): q6's median and std (the
    generic engine, which no other question reaches) and q9's correlation."""
    import cudf_tpu_torch.ops.fastgroup as fastgroup
    import cudf_tpu_torch.ops.groupby as groupby

    return {"q6: the generic engine's answer altered":
            (groupby, "generic_groupby", _altered, 2**33 + 4),
            "q9: each group's correlation altered":
            (fastgroup, "grouped_corr", _altered, 2**33)}


def _half_rows(fn):
    def wrapper(*a, **k):
        out = fn(*a, **k)
        return out.slice(0, out.num_rows // 2)
    return wrapper


def _shared_faults():
    """The fault that ``test_portbench_cells.py`` runs in this cell, whose
    seed starts with q8: half of each compaction's rows left out, q8's head
    (and q9's filter) among them."""
    import cudf_tpu_torch.frame.dataframe as frame

    return {"half of each compaction's rows left out":
            (frame.sc, "apply_boolean_mask", _half_rows)}


def _register():
    conftest.TINY.setdefault(CONFIG, H2O_TINY)
    try:
        from portbench import test_portbench_cells as cells
    except ImportError:  # collected without it
        return
    shared = cells._faults
    if getattr(shared, "h2o", False):
        return

    def faults(w):
        return _shared_faults() if w == CELL else shared(w)
    faults.h2o = True
    cells._faults = faults


_register()


def _frame(raw, spec) -> pd.DataFrame:
    cfg = mf.config_module(CONFIG)
    labels = cfg.labels(spec)
    return pd.DataFrame({n: (labels[n][v.numpy()] if n in labels else v.numpy())
                         for n, v in raw["x"].items()})


def _pandas(x: pd.DataFrame) -> dict:
    """q1-q9 in pandas, as the benchmark's pandas solution writes them."""
    g = x.groupby
    q7 = g("id3", as_index=False).agg({"v1": "max", "v2": "min"})
    q7["range_v1_v2"] = q7["v1"] - q7["v2"]
    q6 = g(["id4", "id5"]).agg({"v3": ["median", "std"]})
    q6.columns = ["v3_median", "v3_std"]
    q9 = g(["id2", "id4"])[["v1", "v2"]].corr().xs("v1", level=2)[["v2"]] ** 2
    return {"q1": g("id1").agg({"v1": "sum"}), "q2": g(["id1", "id2"]).agg({"v1": "sum"}),
            "q3": g("id3").agg({"v1": "sum", "v3": "mean"}),
            "q4": g("id4").agg({"v1": "mean", "v2": "mean", "v3": "mean"}),
            "q5": g("id6").agg({"v1": "sum", "v2": "sum", "v3": "sum"}), "q6": q6,
            "q7": q7[["id3", "range_v1_v2"]],
            "q8": x[["id6", "v3"]].sort_values("v3", ascending=False, kind="stable")
                  .groupby("id6").head(2),
            "q9": q9.rename(columns={"v2": "r2"})}


@pytest.mark.parametrize("data_seed", [0, 5])
def test_reference_equals_pandas(data_seed):
    spec = _spec(data_seed)
    cfg, ref = mf.config_module(CONFIG), mf.reference_module(CONFIG)
    raw = cfg.generate(spec, SEED, "cpu")
    want = ref.answers(raw, spec, [(q, ()) for q in cfg.OPERATIONS], torch.float64)
    for q, got in _pandas(_frame(raw, spec)).items():
        r = compare.compare(got, want[(q, ())][0])
        assert r["mismatches"] == 0 and r["max_rel_err"] < 1e-12, (q, r)
        assert len(got) > 0, q


def test_the_data_is_fixed_whatever_the_seed():
    spec = _spec()
    cfg = mf.config_module(CONFIG)
    a, b = cfg.generate(spec, 1, "cpu")["x"], cfg.generate(spec, 2, "cpu")["x"]
    assert list(a) == list(spec["tables"]["x"]["columns"])
    assert all(torch.equal(a[c], b[c]) for c in a)
    assert int(a["v1"].min()) == 1 and int(a["v1"].max()) == 5
    assert int(a["v2"].max()) == 15 and int(a["id6"].max()) == 2000
    assert float(a["v3"].max()) < 100.0 + 1e-9
    assert torch.equal(a["v3"], torch.round(a["v3"], decimals=6))


@pytest.mark.parametrize("traced", [False, True])
def test_port_equals_reference_through_a_run(traced):
    """Untraced, as long as the window lasts; traced, two blocks: every
    question twice."""
    out = cell.run(CELL, SEED, 0.5, traced, "cpu", sizes=H2O_TINY)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out
    want = {m["name"] for m in mf.metrics_of(M, mf.cell(M, CELL), traced)}
    assert set(out["metrics"]) <= want
    if traced:  # the CPU trace has the program's ranges, not the card's work
        assert out["attempted"] == 18
        assert {"groupby_generic_share", "groupby_head_share"} <= set(out["metrics"])


def test_control_is_not_correct():
    work, spec = mf.cell(M, CELL), _spec()
    for seed in (SEED, 7, 8):
        reading = readings.control_reading(work, spec, seed, "cpu")
        assert reading["max_rel_err"] > spec["checks"]["max_rel_err"], reading


@pytest.mark.parametrize("name", list(_faults()))
def test_a_fault_in_one_question_makes_correct_false(name, monkeypatch):
    mod, attr, wrap, seed = _faults()[name]
    out = cell.run(CELL, seed, 0.3, False, "cpu", sizes=H2O_TINY)
    assert out["correct"], out["checks"]
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    out = cell.run(CELL, seed, 0.3, False, "cpu", sizes=H2O_TINY)
    assert out["correct"] is False and out["failed"] == 0, (name, out["checks"])


# ------------------------------------------------------------- the readers
def _ctx(ranges=()):
    trace = Trace((0, 1000 * MS), sorted(ranges, key=lambda r: (r[1], -r[2])), [])
    return cell.Context(_spec(), 0.0, trace.window_s, [], None, {}, trace)


@pytest.mark.parametrize("name", ["groupby_generic_share", "groupby_head_share"])
def test_none_without_the_programs_ranges(name):
    """The parent program's trace: a groupby with no lane ranges, a sort and
    a compaction; and no trace at all."""
    ctx = _ctx([("groupby_aggregate", 0, 300 * MS), ("sort_by_key", 400 * MS, 500 * MS),
                ("apply_boolean_mask", 600 * MS, 650 * MS)])
    assert mf.metric_module(name).read(ctx) is None
    assert mf.metric_module(name).read(cell.Context(_spec(), 0.0, 1.0, [], None, {},
                                                    None)) is None


def test_generic_share_counts_the_outermost_engine_calls():
    ranges = [("groupby_aggregate", 0, 300 * MS), ("groupby.onehot", 0, 1 * MS),
              ("groupby.sort", 1 * MS, 2 * MS), ("groupby.wide", 2 * MS, 3 * MS),
              ("groupby.generic", 3 * MS, 250 * MS),
              ("groupby.generic", 10 * MS, 20 * MS),   # nested: counted once
              ("groupby_aggregate", 400 * MS, 500 * MS), ("groupby.sort", 400 * MS, 480 * MS),
              ("groupby.generic", 600 * MS, 650 * MS)]
    got = mf.metric_module("groupby_generic_share").read(_ctx(ranges))
    assert got == pytest.approx(100 * (247 + 50) / 1000)


def test_head_share_counts_each_head():
    ranges = [("groupby_head", 100 * MS, 400 * MS), ("apply_boolean_mask", 300 * MS, 390 * MS),
              ("sort_by_key", 500 * MS, 600 * MS), ("groupby_head", 700 * MS, 720 * MS)]
    got = mf.metric_module("groupby_head_share").read(_ctx(ranges))
    assert got == pytest.approx(100 * 320 / 1000)
