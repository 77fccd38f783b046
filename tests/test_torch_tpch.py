"""TPC-H q1, q3, q5 and q6 on the port's IR executor against cudf_tpu's
and pandas.

``benchmarks/tpch.py`` is loaded by path (it imports jax only inside
``main``) and its own plan builders build each query once on each package,
over ``gen_tables(4000)``. The port runs on the CPU, where the hash-table
lane runs the probe kernel's plain version. The port's frame must equal
the reference's ``IR.execute`` and the pandas oracle: keys, counts and row
order exact, float sums rtol 1e-6 (tpch.py's own check).
"""
import importlib.util
import pathlib

import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR

import cudf_tpu_torch as tt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.kernels import hashtable as tht

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUERIES = ["q1", "q3", "q5", "q6"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tpch = _load("tpch_bench", ROOT / "benchmarks" / "tpch.py")


@pytest.fixture(scope="module")
def data():
    host = tpch.gen_tables(4000)
    ref = {k: ct.Table.from_pandas(v) for k, v in host.items()}
    port = {k: tt.Table.from_pandas(v, device="cpu") for k, v in host.items()}
    return host, ref, port


def _plans(q, ref, port):
    build = tpch.QUERIES[q][0]
    return (build(lambda n: RIR.DataFrameScan(ref[n]), RE, RIR, RE.col),
            build(lambda n: TIR.DataFrameScan(port[n]), TE, TIR, TE.col))


@pytest.fixture(scope="module")
def results(data):
    """Each query's (port, reference, pandas) frames and the probe kernel's
    calls in the port's run."""
    host, ref, port = data
    out = {}
    for q in QUERIES:
        rplan, pplan = _plans(q, ref, port)
        calls = []
        inner = tht.probe_table

        def spy(*a):
            calls.append(1)
            return inner(*a)

        tht.probe_table = spy
        try:
            got = TIR.execute(pplan).to_pandas()
        finally:
            tht.probe_table = inner
        out[q] = (got, RIR.execute(rplan).to_pandas(), tpch.QUERIES[q][1](host), len(calls))
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_query_equals_reference_and_pandas(results, q):
    got, want_ref, want_pd = results[q][:3]
    assert len(got) > 0
    assert list(got.columns) == list(want_ref.columns)
    pd.testing.assert_frame_equal(got, want_ref, rtol=1e-6, check_dtype=False)
    pd.testing.assert_frame_equal(got[want_pd.columns], want_pd, rtol=1e-6,
                                  check_dtype=False)


@pytest.mark.parametrize("q,joins", [("q1", 0), ("q3", 2), ("q5", 5), ("q6", 0)])
def test_joins_take_the_hash_lane(results, q, joins):
    """Every join of q3 and q5 has its dimension side on the left; the swap
    builds on it, so each join probes once."""
    assert results[q][3] == joins


@pytest.mark.parametrize("q", QUERIES)
def test_projection_pushdown_matches_reference(data, q):
    _, ref, port = data
    rplan, pplan = _plans(q, ref, port)
    names = {id(t): n for n, t in ref.items()} | {id(t): n for n, t in port.items()}

    def by_table(needs):
        return {names[id(node._tbl)]: sorted(cols) for node, cols in needs.items()}

    (rn, rf), (pn, pf) = RIR.scan_column_requirements(rplan), TIR.scan_column_requirements(pplan)
    assert by_table(pn) == by_table(rn)
    assert sorted(map(sorted, pf.values())) == sorted(map(sorted, rf.values()))


def test_chip_smoke_copies_equal_the_benchmark():
    """chip_smoke.py keeps its own copies of gen_tables and the plan
    builders, and its own oracles: they equal tpch.py's."""
    smoke = _load("chip_smoke_copy", ROOT / "chip_smoke.py")
    mine, theirs = smoke.gen_tables(3000, seed=4), tpch.gen_tables(3000, seed=4)
    assert list(mine) == list(theirs)
    for name in theirs:
        pd.testing.assert_frame_equal(mine[name], theirs[name])
    tables = {k: tt.Table.from_pandas(v, device="cpu") for k, v in theirs.items()}
    scans = {k: TIR.DataFrameScan(t) for k, t in tables.items()}
    oracles = smoke.tpch_oracles(theirs)
    for q in QUERIES:
        assert repr(smoke.BUILDERS[q](scans.get, TE, TIR, TE.col)) == \
            repr(tpch.QUERIES[q][0](scans.get, TE, TIR, TE.col))
        pd.testing.assert_frame_equal(oracles[q], tpch.QUERIES[q][1](theirs), rtol=1e-12)
