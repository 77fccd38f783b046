"""The db-benchmark groupby questions through the port, and the two
grouped methods they brought: ``DataFrameGroupBy.head`` and ``.corr``.

q1-q9 run as the benchmark runs them (``portbench/configs/h2o_g1_1e8.py``,
its generator at N = 20,000 and K = 10, two data seeds) against the plain
torch reference (``portbench/reference/h2o_g1_1e8.py``) through the
benchmark's own comparison: exact keys, counts and integer answers, float
answers within 1e-12. ``head`` and ``corr`` are held against the
installed pandas on frames with null and NaN keys under both ``dropna``,
a NaN in one value column only, one-row and zero-variance groups, int and
float columns, on the sort lane and on the generic engine; the exact
integer moments keep r's relative error at a few ulp where r is near 0,
and a correlation gives the same bits twice.
"""
from decimal import Decimal, getcontext

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ctt
from cudf_tpu_torch.ops import fastgroup, groupby as G, sortgroup
from portbench.harness import compare, manifest as mf
from portbench.harness.cell import quiet_span

CONFIG = "h2o_g1_1e8"
TINY = {"tables": {"x": 20000}, "datagen": {"K": 10}}


def _spec(data_seed):
    spec = mf.resize(mf.spec(mf.load(), CONFIG), TINY)
    spec["data_seed"] = data_seed
    return spec


@pytest.mark.parametrize("data_seed", [0, 1])
def test_questions_equal_the_reference(data_seed):
    spec = _spec(data_seed)
    cfg, ref = mf.config_module(CONFIG), mf.reference_module(CONFIG)
    state = cfg.build(cfg.generate(spec, 0, "cpu"), spec, list(cfg.OPERATIONS), "cpu")
    got = {q: fn(state, quiet_span, ()) for q, fn in cfg.OPERATIONS.items()}
    want = ref.answers(cfg.generate(spec, 0, "cpu"), spec, [(q, ()) for q in got],
                       torch.float64)
    for q, out in got.items():
        answer, counts = want[(q, ())]
        r = compare.compare(out, answer)
        assert r["mismatches"] == 0 and r["max_rel_err"] < 1e-12, (q, r)
        assert len(out) == len(next(iter(answer.values()))) > 0, q
        for gb in counts["groupbys"]:  # groups of several rows each
            assert gb["rows"] >= 8 * gb["groups"], (q, gb)
    assert len(got["q8"]) > 2 * 1000 - 10  # two rows of (nearly) each of N/K id6


def _keyed_frame(seed=0, n=300):
    """Keys with nulls (``kn``) and NaN (``kf``), a group of one row, a
    group whose values are all equal, an int and a float column, and a NaN
    in the float column only."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n)
    k[0] = 9                      # a group of one row
    kf = k.astype(np.float64)
    kf[rng.random(n) < 0.08] = np.nan
    kn = pd.array(k, dtype="Int64")
    kn[rng.random(n) < 0.08] = pd.NA
    i = rng.integers(-20, 20, n)
    i[k == 4] = 7                 # zero variance in one column of group 4
    f = rng.normal(size=n) * 10
    f[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({"k": k, "kf": kf, "kn": kn, "k2": rng.integers(0, 2, n),
                         "i": i, "f": f, "g": f * 0.5 + rng.normal(size=n)})


KEYS = [["k"], ["kf"], ["kn"], ["k", "k2"], ["kf", "k2"]]


def _same_frame(got: pd.DataFrame, want: pd.DataFrame, rtol=0.0):
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index), (got.index, want.index)
    for c in want.columns:
        g, w = got[c].to_numpy(dtype=np.float64), want[c].to_numpy(dtype=np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), c
        np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)], rtol=rtol, atol=0)


@pytest.mark.parametrize("keys", KEYS, ids=lambda k: "+".join(k))
@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("n", [0, 1, 3, 200])
def test_head_equals_pandas(keys, dropna, n):
    pdf = _keyed_frame()
    got = ctt.DataFrame(pdf, device="cpu").groupby(keys, dropna=dropna).head(n).to_pandas()
    want = pdf.groupby(keys, dropna=dropna).head(n)
    assert list(got.index) == list(want.index)
    _same_frame(got.drop(columns=["kn"]), want.drop(columns=["kn"]))
    assert got["kn"].isna().tolist() == want["kn"].isna().tolist()


def test_head_after_a_sort_keeps_the_sorted_order_and_index():
    pdf = _keyed_frame(1)
    df = ctt.DataFrame(pdf, device="cpu")
    got = df[["k", "f"]].sort_values("f", ascending=False).groupby("k").head(2).to_pandas()
    want = pdf[["k", "f"]].sort_values("f", ascending=False).groupby("k").head(2)
    assert list(got.index) == list(want.index)
    _same_frame(got, want)


def test_head_of_selected_columns_and_a_negative_n():
    pdf = _keyed_frame(2)
    df = ctt.DataFrame(pdf, device="cpu")
    got = df.groupby("k")[["i", "f"]].head(1).to_pandas()
    want = pdf.groupby("k")[["i", "f"]].head(1)
    _same_frame(got, want)
    with pytest.raises(NotImplementedError):
        df.groupby("k").head(-1)


def _corr_lanes():
    real = sortgroup.sort_groupby
    return {"sort": real, "generic": lambda *a, **k: None}


@pytest.mark.parametrize("lane", ["sort", "generic"])
@pytest.mark.parametrize("keys", KEYS, ids=lambda k: "+".join(k))
@pytest.mark.parametrize("dropna", [True, False])
def test_corr_equals_pandas(lane, keys, dropna, monkeypatch):
    pdf = _keyed_frame(3)
    cols = ["i", "f", "g"]
    monkeypatch.setattr(sortgroup, "sort_groupby", _corr_lanes()[lane])
    calls = []
    corr = fastgroup.grouped_corr
    monkeypatch.setattr(fastgroup, "grouped_corr", lambda *a: calls.append(1) or corr(*a))
    generic = []
    monkeypatch.setattr(G, "generic_groupby",
                        lambda *a, _g=G.generic_groupby: generic.append(1) or _g(*a))
    got = ctt.DataFrame(pdf, device="cpu").groupby(keys, dropna=dropna)[cols].corr()
    got = got.to_pandas()
    want = pdf.groupby(keys, dropna=dropna)[cols].corr()
    assert calls and len(generic) == (lane == "generic")
    assert got.index.names == want.index.names
    assert [t[-1] for t in got.index] == [t[-1] for t in want.index]
    _same_frame(got.reset_index(drop=True), want.reset_index(drop=True), rtol=1e-12)
    kept = got.reset_index()
    for i, name in enumerate(keys):
        a = kept[name].to_numpy(dtype=np.float64, na_value=np.nan)
        b = pd.array([t[i] for t in want.index], dtype="Float64").to_numpy(
            dtype=np.float64, na_value=np.nan)
        assert np.array_equal(a, b, equal_nan=True), name


def test_corr_of_all_value_columns_and_its_edge_groups():
    """Group 9 has one row, group 4 a constant ``i``: NaN off the diagonal,
    and on ``i``'s diagonal; a float column with a NaN drops only that row
    from its pairs."""
    pdf = _keyed_frame(4)[["k", "i", "f", "g"]]
    got = ctt.DataFrame(pdf, device="cpu").groupby("k").corr().to_pandas()
    want = pdf.groupby("k").corr()
    _same_frame(got.reset_index(drop=True), want.reset_index(drop=True), rtol=1e-12)
    assert np.isnan(got.loc[(9, "f"), "g"]) and np.isnan(got.loc[(4, "i"), "i"])
    assert got.loc[(4, "f"), "f"] == 1.0


def _exact_r(x, y) -> float:
    getcontext().prec = 60
    n = len(x)
    sx, sy = sum(x), sum(y)
    c = n * sum(a * b for a, b in zip(x, y)) - sx * sy
    a = n * sum(a * a for a in x) - sx * sx
    b = n * sum(b * b for b in y) - sy * sy
    return float(Decimal(c) / (Decimal(a) * Decimal(b)).sqrt())


def test_integer_moments_keep_r_near_zero_to_a_few_ulp():
    """r of 1e-5 to 1e-4 (r2 of 1e-10 to 1e-8), where a one-pass
    Σxy − ΣxΣy/n in float64 loses about six digits: the exact int64
    moments give it within 8 ulp (two passes in float64 miss by ~1e-12).
    Each group holds every (x, y) of 1..5 × 1..15 equally often,
    shuffled (no correlation at all), and then one y moved by d, which
    makes n·Σxy − Σx·Σy = d·n·(x − 3)."""
    rng = np.random.default_rng(5)
    pairs = np.array([(x, y) for x in range(1, 6) for y in range(1, 16)])
    rows = []
    for g in range(24):
        xy = np.tile(pairs, (40 + 7 * g, 1))[rng.permutation(75 * (40 + 7 * g))]
        j = np.flatnonzero((xy[:, 0] != 3) & (xy[:, 1] > 1) & (xy[:, 1] < 15))[0]
        xy[j, 1] += 1 if g % 2 else -1
        rows.append(pd.DataFrame({"k": g, "x": xy[:, 0], "y": xy[:, 1]}))
    pdf = pd.concat(rows, ignore_index=True).astype({"x": np.int32, "y": np.int32})
    got = ctt.DataFrame(pdf, device="cpu").groupby("k")[["x", "y"]].corr().to_pandas()
    r = got.xs("x", level=1)["y"].to_numpy()
    exact = np.array([_exact_r(d["x"].tolist(), d["y"].tolist()) for _, d in pdf.groupby("k")])
    assert np.all(np.abs(exact) < 2e-4) and np.all(exact != 0)
    assert np.max(np.abs(r - exact) / np.abs(exact)) < 8 * np.finfo(np.float64).eps


@pytest.mark.parametrize("lane", ["sort", "generic"])
def test_corr_gives_the_same_bits_twice(lane, monkeypatch):
    monkeypatch.setattr(sortgroup, "sort_groupby", _corr_lanes()[lane])
    rng = np.random.default_rng(6)
    n = 50000
    pdf = pd.DataFrame({"k": rng.integers(0, 300, n), "a": rng.normal(size=n) * 1e3,
                        "b": rng.normal(size=n)})
    df = ctt.DataFrame(pdf, device="cpu")
    one, two = (df.groupby("k")[["a", "b"]].corr().to_pandas().to_numpy() for _ in range(2))
    assert np.array_equal(one.view(np.int64), two.view(np.int64))


def test_corr_is_a_sort_lane_kind_only():
    """The wide lane and the chunked partials refuse it; the sort lane and
    the generic engine take it."""
    assert "corr" in sortgroup._SUPPORTED and "corr" not in fastgroup._SUPPORTED
    from cudf_tpu_torch.ops import streaming_groupby
    assert "corr" not in streaming_groupby.SUPPORTED
