"""Each cell at tiny seeded sizes on the CPU: the reference against
pandas, the port against the reference through the harness's own
comparison, the control and the faults that the comparison must catch."""
import numpy as np
import pandas as pd
import pytest
import torch

from portbench.harness import cell, compare, manifest as mf
from portbench import readings

M = mf.load()
CELLS = [w["name"] for w in M["workloads"]]
SEED = 2**31 + 12345  # more than 32 signed bits hold


def _spec(config, tiny):
    return mf.resize(mf.spec(M, config), tiny[config])


def _frames(raw, cfg):
    out = {}
    for t, cols in raw.items():
        data = {}
        for n, v in cols.items():
            a = v.numpy()
            if n in cfg.DICTIONARIES:
                a = np.array(cfg.DICTIONARIES[n], dtype=object)[a]
            elif n.endswith("date"):
                a = a.astype("datetime64[ns]")
            data[n] = a
        out[t] = pd.DataFrame(data)
    return out


def _q1_pandas(li, delta):
    q1 = li[li.l_shipdate <= pd.Timestamp("1998-12-01") - pd.Timedelta(days=delta)]
    dp = q1.l_extendedprice * (1 - q1.l_discount)
    q1 = q1.assign(dp=dp, ch=dp * (1 + q1.l_tax))
    return q1.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("dp", "sum"), sum_charge=("ch", "sum"),
        avg_qty=("l_quantity", "mean"), avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"))


def _q3_pandas(t, segment, day):
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    cut = pd.Timestamp(day)
    m = (c[c.c_mktsegment == segment]
         .merge(o[o.o_orderdate < cut], left_on="c_custkey", right_on="o_custkey")
         .merge(li[li.l_shipdate > cut], left_on="o_orderkey", right_on="l_orderkey"))
    m["revenue"] = m.l_extendedprice * (1 - m.l_discount)
    return (m.groupby(["o_orderkey", "o_shippriority"], as_index=False)
            .agg(revenue=("revenue", "sum"))
            .sort_values("revenue", ascending=False, kind="stable").head(10))


def _q5_pandas(t, region, year):
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    r, n, s = t["region"], t["nation"], t["supplier"]
    o5 = o[(o.o_orderdate >= pd.Timestamp(f"{year}-01-01"))
           & (o.o_orderdate < pd.Timestamp(f"{year + 1}-01-01"))]
    m = c.merge(o5, left_on="c_custkey", right_on="o_custkey").merge(
        li, left_on="o_orderkey", right_on="l_orderkey")
    sn = s.merge(n, left_on="s_nationkey", right_on="n_nationkey").merge(
        r[r.r_name == region], left_on="n_regionkey", right_on="r_regionkey")
    m = sn.merge(m, left_on=["s_suppkey", "s_nationkey"], right_on=["l_suppkey", "c_nationkey"])
    m["revenue"] = m.l_extendedprice * (1 - m.l_discount)
    return (m.groupby("n_name", as_index=False).agg(revenue=("revenue", "sum"))
            .sort_values("revenue", ascending=False, kind="stable"))


def _q6_pandas(t, year, discount, quantity):
    li = t["lineitem"]
    m = li[(li.l_shipdate >= pd.Timestamp(f"{year}-01-01"))
           & (li.l_shipdate < pd.Timestamp(f"{year + 1}-01-01"))
           & (li.l_discount >= (discount - 1) / 100) & (li.l_discount <= (discount + 1) / 100)
           & (li.l_quantity < quantity)]
    return pd.DataFrame({"revenue": [(m.l_extendedprice * m.l_discount).sum()]})


PANDAS = {"q1": lambda t, *p: _q1_pandas(t["lineitem"], *p), "q3": _q3_pandas,
          "q5": _q5_pandas, "q6": _q6_pandas,
          "ingest_q1": lambda t, *p: _q1_pandas(t["lineitem"], *p)}


@pytest.mark.parametrize("config", ["tpch_sf30", "q1frame_sf30"])
def test_reference_equals_pandas(config, tiny):
    """Each operation, at parameters drawn as a run draws them, against
    the same query in pandas."""
    spec = _spec(config, tiny)
    cfg, ref = mf.config_module(config), mf.reference_module(config)
    raw = cfg.generate(spec, SEED, "cpu")
    draw = cell.parameters(cfg, SEED, 1)
    runs = [(op, draw(op)) for op in spec["operations"] for _ in range(4)]
    want = ref.answers(raw, spec, runs, torch.float64)
    frames = _frames(raw, cfg)
    for op, params in runs:
        got = PANDAS[op](frames, *params).reset_index(drop=True)
        r = compare.compare(got, want[(op, params)][0])
        assert r["mismatches"] == 0 and r["max_rel_err"] < 1e-12, (op, params, r)
        assert len(got) > 0, (op, params)


def test_the_data_is_fixed_and_the_parameters_follow_the_seed(tiny):
    """dbgen's data at a scale factor is one set; each execution's
    substitution parameters come from the run's seed."""
    spec = _spec("tpch_sf30", tiny)
    cfg = mf.config_module("tpch_sf30")
    a, b = cfg.generate(spec, 1, "cpu"), cfg.generate(spec, 2, "cpu")
    assert all(torch.equal(a[t][c], b[t][c]) for t in a for c in a[t])
    draws = {s: [cell.parameters(cfg, s, 1)(op) for op in ("q1", "q3", "q5", "q6") * 8]
             for s in (1, 1, 2)}
    assert draws[1] == [cell.parameters(cfg, 1, 1)(op) for op in ("q1", "q3", "q5", "q6") * 8]
    assert draws[1] != draws[2]


@pytest.mark.parametrize("w", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_port_equals_reference_through_a_run(w, traced, tiny):
    work = mf.cell(M, w)
    out = cell.run(w, SEED, 0.3, traced, "cpu", sizes=tiny[work["config"]])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out
    assert list(out)[-1] == "checks"
    assert out["checks"]["mismatches"]["value"] == 0
    want = {m["name"] for m in mf.metrics_of(M, work, traced)}
    # a CPU run has no device numbers: those metrics are left out, never 0
    assert set(out["metrics"]) <= want
    if traced:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("w", CELLS)
def test_control_is_not_correct(w, tiny):
    """The reference in the configuration's control precision, put in the
    program's place, fails the comparison's limits."""
    work = mf.cell(M, w)
    spec = _spec(work["config"], tiny)
    for seed in (SEED, 7, 8):
        assert not compare.passes(readings.control_reading(work, spec, seed, "cpu"),
                                  spec["checks"])


def _scaled(col, factor):
    from cudf_tpu_torch import Column

    return Column(col.dtype, col.data * factor, col.validity, col.length, col.dictionary)


def _alter_floats(fn):
    """``fn`` with its result's float values altered by 1e-3."""
    def wrapper(*a, **k):
        from cudf_tpu_torch import Table

        out = fn(*a, **k)
        return Table({n: _scaled(c, 1 + 1e-3) if c.dtype.is_floating else c for n, c in out})
    return wrapper


def _half_rows(fn):
    def wrapper(*a, **k):
        out = fn(*a, **k)
        return out.slice(0, out.num_rows // 2)
    return wrapper


def _faults(w):
    import cudf_tpu_torch.expr.ir as ir
    import cudf_tpu_torch.frame.dataframe as frame
    import cudf_tpu_torch.frame.groupby as fgroupby
    import cudf_tpu_torch.ops.stream_compaction as sc

    tpch = {"groupby answer altered": (ir, "groupby_aggregate", _alter_floats),
            "half of each filter's rows left out": (sc, "apply_boolean_mask", _half_rows)}
    q1frame = {"groupby answer altered": (fgroupby, "groupby_aggregate", _alter_floats),
               "half of the filter's rows left out, the mean over the rest":
               (frame.sc, "apply_boolean_mask", _half_rows)}
    return {"tpch_sf30.joins": {**tpch, "half of each join's rows left out":
                                (ir.join_ops, "join", _half_rows)},
            "tpch_sf30.scan_agg": tpch,
            "q1frame_sf30.resident": q1frame, "q1frame_sf30.ingest": q1frame}[w]


@pytest.mark.parametrize("w", CELLS)
def test_faults_make_correct_false(w, tiny, monkeypatch):
    """A run whose timed path is broken underneath comes out not correct,
    one fault at a time."""
    work = mf.cell(M, w)
    for name, (mod, attr, wrap) in _faults(w).items():
        with monkeypatch.context() as mp:
            mp.setattr(mod, attr, wrap(getattr(mod, attr)))
            out = cell.run(w, SEED, 0.2, False, "cpu", sizes=tiny[work["config"]])
        assert out["correct"] is False, (name, out["checks"])
