"""The port's mesh execution (``cudf_tpu_torch/parallel/spmd.py`` and
``plan_executor.execute_spmd``) against cudf_tpu's, on the same seeded
inputs: the reference on conftest's 8-device CPU mesh, the port on
``make_mesh(8, devices=["cpu"])``.

* The cases of ``tests/test_parallel.py`` and ``tests/test_spmd_round3.py``
  run through both packages (parametrised, not repeated).
* Shard placement: a non-null int64 or f64 key hashes as the reference's
  does, so each shard holds the reference's rows in the reference's order
  (exact). A string key hashes by value, narrow ints widen and a null
  reads as 0 (``plan_executor._shuffle_key``), so those shards are held as
  multisets: every row kept, every key on one shard.
* Groupby: each shard's groups as a frame sorted by key, against the
  reference's shard for int64 keys and against pandas always; keys,
  counts and integer aggregates exact, floats at the JAX tests' rtol 1e-9.
  The port's shard-local groupby is its own dispatch (the one-hot and
  sort lanes), whose group order is not the reference's.
* Joins, distinct and elementwise stages: row multisets against the
  reference and pandas.
* The sort: row for row equal to ``sort_by_key`` and to the reference's
  ``dist_sort_values``, and each shard as long as the reference's (the
  order words are bit-equal, so the splitters are).
* ``execute_spmd`` on benchmarks/tpch.py's plans at ``gen_tables(4000)``:
  equal to ``IR.execute``, q3's top 10 and q5's order exactly.
* Reference faults pinned: its ``dist_join`` on a string key whose two
  tables were built with different dictionaries hashes codes, not values;
  its ``execute_spmd`` keeps a null-key group that ``IR.execute`` drops.
"""
import importlib.util
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as ct
from cudf_tpu.expr import expressions as RE
from cudf_tpu.expr import ir as RIR
from cudf_tpu.ops import sorting as rsorting
from cudf_tpu.ops import sortprim as rsortprim
from cudf_tpu.ops.groupby import AggSpec as RAgg
from cudf_tpu.parallel import spmd as rspmd
from cudf_tpu.parallel.plan_executor import execute_spmd as rexecute_spmd

import cudf_tpu_torch as tt
from cudf_tpu_torch.expr import expressions as TE
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.ops import sorting as tsorting
from cudf_tpu_torch.ops import sortprim as tsortprim
from cudf_tpu_torch.ops.groupby import AggSpec as TAgg
from cudf_tpu_torch.parallel import spmd as tspmd
from cudf_tpu_torch.parallel.plan_executor import execute_spmd as texecute_spmd

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("tpch_bench", ROOT / "benchmarks" / "tpch.py")
tpch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpch)

N = 8


@pytest.fixture(scope="module", autouse=True)
def _drop_the_reference_traces():
    """The reference's jitted ops keep a string column's dictionary from
    their first trace (pinned in test_torch_lists.py): the traces made here
    are dropped when the module ends, so no later module decodes with them."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(scope="module")
def meshes():
    return rspmd.make_mesh(N), tspmd.make_mesh(N, devices=["cpu"])


def _split(df, n=N):
    parts = np.array_split(np.arange(len(df)), n)
    return [df.iloc[p].reset_index(drop=True) for p in parts]


def _sharded(df, meshes):
    rmesh, tmesh = meshes
    parts = _split(df)
    return (rspmd.ShardedTable.from_tables([ct.Table.from_pandas(p) for p in parts], rmesh),
            tspmd.ShardedTable.from_tables(
                [tt.Table.from_pandas(p, device="cpu") for p in parts], tmesh))


def _shards(st):
    return [t.to_pandas() for t in st.to_tables()]


def _sorted(df, cols=None):
    cols = list(df.columns) if cols is None else cols
    return df.sort_values(cols, kind="stable").reset_index(drop=True)


def _same_rows(got, want, cols=None, **kw):
    cols = cols or sorted(want.columns)
    pd.testing.assert_frame_equal(_sorted(got[cols], cols), _sorted(want[cols], cols),
                                  check_dtype=False, **kw)


# ------------------------------------------------------------------ mesh
def test_mesh_shards_share_devices_round_robin():
    mesh = tspmd.make_mesh(3, devices=["cpu"])
    assert mesh.size == 3 and mesh.shape == {"shards": 3}
    assert [d.type for d in mesh.devices] == ["cpu"] * 3
    assert mesh.processes == (0, 0, 0) and mesh.local_shards() == [0, 1, 2]


def test_mesh_without_devices_needs_cuda():
    if torch.cuda.is_available():
        assert tspmd.make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tspmd.make_mesh()


# --------------------------------------------------------------- shuffle
def _shuffle_frame(kind, rng, n=1000):
    if kind == "int64":
        return pd.DataFrame({"k": rng.integers(0, 50, n), "v": rng.normal(size=n)})
    if kind == "float64":
        return pd.DataFrame({"k": rng.integers(0, 30, n) / 4.0, "v": rng.normal(size=n)})
    if kind == "int32":
        return pd.DataFrame({"k": rng.integers(0, 50, n).astype(np.int32),
                             "v": rng.normal(size=n)})
    if kind == "string":
        return pd.DataFrame({"k": rng.choice(["apple", "pear", "plum", "fig", "kiwi"], n),
                             "v": rng.normal(size=n)})
    k = pd.array(np.where(rng.random(n) < 0.1, None, rng.integers(0, 20, n)), dtype="Int64")
    return pd.DataFrame({"k": k, "v": rng.normal(size=n)})


@pytest.mark.parametrize("kind", ["int64", "float64", "int32", "string", "masked"])
def test_shuffle_preserves_rows_and_collocates_keys(meshes, kind):
    df = _shuffle_frame(kind, np.random.default_rng(0))
    rst, tst = _sharded(df, meshes)
    (rsh, rov), (tsh, tov) = rspmd.shuffle_by_key(rst, ["k"]), tspmd.shuffle_by_key(tst, ["k"])
    assert rov == 0 and tov == 0
    got = _shards(tsh)
    _same_rows(pd.concat(got), df, ["k", "v"])
    seen = {}
    for i, s in enumerate(got):
        for k in s["k"].astype(object).where(s["k"].notna(), None).unique():
            assert seen.setdefault(k, i) == i, f"key {k} split across shards"
    if kind in ("int64", "float64"):
        # the reference's hash: the reference's rows, in its order, on each shard
        for g, r in zip(got, _shards(rsh)):
            pd.testing.assert_frame_equal(g, r, check_dtype=False)


def test_shuffle_auto_retry_absorbs_skew(meshes):
    """tests/test_parallel.py's skew case: bucket=8 forced tiny; the
    reference retries with doubled blocks, the port's blocks are exact."""
    rng = np.random.default_rng(10)
    k = np.where(rng.random(2000) < 0.95, 3, rng.integers(0, 50, 2000))
    df = pd.DataFrame({"k": k, "v": np.ones(2000)})
    for spmd, st in zip((rspmd, tspmd), _sharded(df, meshes)):
        shuffled, overflow = spmd.shuffle_by_key(st, ["k"], bucket=8)
        assert overflow == 0
        out = shuffled.concat_to_table().to_pandas()
        assert len(out) == len(df) and out["v"].sum() == df["v"].sum()


# --------------------------------------------------------------- groupby
AGG_KINDS = ["sum", "mean", "min", "max", "count", "size", "var", "std", "m2",
             "sum_of_squares", "product", "nunique", "median", "quantile", "first",
             "last", "any", "all"]


def _groupby_frame(kind, rng, n=2000):
    if kind == "int":
        df = pd.DataFrame({"k1": rng.integers(0, 30, n), "k2": rng.integers(0, 4, n)})
    elif kind == "string":
        df = pd.DataFrame({"k1": rng.choice(["apple", "pear", "plum", "fig"], n)})
    else:  # skewed: 90% of rows share one key
        df = pd.DataFrame({"k1": np.where(rng.random(n) < 0.9, 7, rng.integers(0, 50, n))})
    df["v"] = rng.normal(size=n)
    df["i"] = rng.integers(-5, 6, n)
    df["b"] = rng.random(n) < 0.5
    return df


def _specs(Agg):
    out = []
    for kind in AGG_KINDS:
        col = "" if kind == "size" else ("b" if kind in ("any", "all") else "v")
        out.append(Agg(col, kind, f"{kind}_v", 0.3 if kind == "quantile" else 0.0))
    out += [Agg("i", "sum", "sum_i"), Agg("i", "nunique", "nunique_i"),
            Agg("i", "min", "min_i")]
    return out


@pytest.mark.parametrize("kind", ["int", "string", "skewed"])
def test_dist_groupby_every_agg(meshes, kind):
    df = _groupby_frame(kind, np.random.default_rng(2))
    keys = [c for c in df.columns if c.startswith("k")]
    rst, tst = _sharded(df, meshes)
    rout = rspmd.dist_groupby(rst, keys, _specs(RAgg))
    tout = tspmd.dist_groupby(tst, keys, _specs(TAgg))
    assert not tspmd.DIST_FALLBACK_COUNTS
    got_shards, ref_shards = _shards(tout), _shards(rout)
    got, ref = pd.concat(got_shards), pd.concat(ref_shards)
    assert len(got) == len(ref) == len(df.groupby(keys))
    _same_rows(got, ref, keys + [s.out_name for s in _specs(TAgg)], rtol=1e-9)
    g = df.groupby(keys)
    want = pd.DataFrame({"sum_v": g["v"].sum(), "mean_v": g["v"].mean(),
                         "size_v": g.size(), "median_v": g["v"].median(),
                         "nunique_i": g["i"].nunique(), "sum_i": g["i"].sum()}).reset_index()
    _same_rows(got, want, keys + list(want.columns[len(keys):]), rtol=1e-9)
    if kind == "int":
        # int64 keys: every group on the reference's shard
        for gs, rs in zip(got_shards, ref_shards):
            assert sorted(map(tuple, gs[keys].values.tolist())) == \
                sorted(map(tuple, rs[keys].values.tolist()))


def test_dist_groupby_keeps_the_null_key_group(meshes):
    """Like the reference's shard body, null keys form a group."""
    df = _shuffle_frame("masked", np.random.default_rng(3))
    rst, tst = _sharded(df, meshes)
    specs = lambda A: [A("v", "sum", "s"), A("", "size", "n")]  # noqa: E731
    got = tspmd.dist_groupby(tst, ["k"], specs(TAgg)).concat_to_table().to_pandas()
    ref = rspmd.dist_groupby(rst, ["k"], specs(RAgg)).concat_to_table().to_pandas()
    want = df.groupby("k", dropna=False).agg(s=("v", "sum"), n=("v", "size")).reset_index()
    want["k"] = want["k"].astype("float64")  # the null key as to_pandas gives it: NaN
    for other in (ref, want):
        _same_rows(got, other, ["k", "s", "n"], rtol=1e-9)


def test_dist_groupby_calls_the_accumulator_only_on_shards_with_rows(meshes, monkeypatch):
    """Four key values on 8 shards leave at least four shards empty after
    the shuffle: the one-hot lane's accumulator runs once for each shard
    that holds rows, and the groups equal groupby_aggregate of the whole
    table (f32 sums at rtol 1e-6: one f32 rounding of each group's total)."""
    from cudf_tpu_torch.kernels import onehot_groupby as tkernel

    rng = np.random.default_rng(4)
    n = 2000
    pairs = np.array([[0, 0], [1, 0], [1, 1], [2, 0]], np.int32)[rng.integers(0, 4, n)]
    df = pd.DataFrame({"a": pairs[:, 0], "b": pairs[:, 1],
                       "v": rng.uniform(900, 105000, n).astype(np.float32)})
    _, tst = _sharded(df, meshes)
    specs = [TAgg("v", "sum", "s"), TAgg("v", "mean", "m"), TAgg("v", "count", "c"),
             TAgg("", "size", "n")]
    holding = sum(k > 0 for k in tspmd.shuffle_by_key(tst, ["a", "b"])[0].lengths)
    assert holding <= 4
    calls = []
    inner = tkernel.groupby_sum_count
    monkeypatch.setattr(tkernel, "groupby_sum_count",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    got = tspmd.dist_groupby(tst, ["a", "b"], specs).concat_to_table().to_pandas()
    assert len(calls) == holding
    whole = tt.groupby_aggregate(tt.Table.from_pandas(df, device="cpu"), ["a", "b"],
                                 specs).to_pandas()
    assert len(calls) == holding + 1 and len(whole) == 4
    _same_rows(got, whole, ["a", "b", "c", "n", "s", "m"], rtol=1e-6)


# ------------------------------------------------------------------ joins
def _mk(rng, n=2000, with_strings=False, dup_right=1):
    """tests/test_spmd_round3.py's join inputs."""
    nd = max(n // 10, 8)
    if with_strings:
        pool = np.array([f"key#{i:05d}" for i in range(nd)])
        dimk = pool
        fk = pool[rng.integers(0, nd, n)]
        missing = np.array([f"zzz#{i:05d}" for i in range(50)])
        fk[rng.integers(0, n, 50)] = missing[np.arange(50)]
    else:
        dimk = np.arange(nd) * 7 + 3
        fk = dimk[rng.integers(0, nd, n)]
        fk[rng.integers(0, n, n // 20)] = -1
    jl = pd.DataFrame({"k": fk, "v": rng.normal(size=n).astype(np.float32)})
    jr = pd.DataFrame({"k": np.repeat(dimk, dup_right),
                       "w": rng.normal(size=nd * dup_right).astype(np.float32)})
    return jl, jr


def _pandas_join(jl, jr, how):
    if how in ("semi", "anti"):
        mask = jl["k"].isin(set(jr["k"].tolist()))
        return jl[mask] if how == "semi" else jl[~mask]
    return jl.merge(jr, on="k", how="outer" if how == "full" else how)


JOIN_CASES = [(how, "numeric", 1) for how in ("inner", "left", "right", "full", "semi", "anti")] \
    + [(how, "numeric", 3) for how in ("inner", "right", "full")] \
    + [(how, "string", 1) for how in ("inner", "right", "full")]


@pytest.mark.parametrize("how,keys,dup", JOIN_CASES,
                         ids=[f"{h}-{k}-x{d}" for h, k, d in JOIN_CASES])
def test_dist_join_every_how(meshes, how, keys, dup):
    jl, jr = _mk(np.random.default_rng(10), with_strings=keys == "string", dup_right=dup)
    (rl, tl), (rr, tr) = _sharded(jl, meshes), _sharded(jr, meshes)
    got = tspmd.dist_join(tl, tr, ["k"], ["k"], how).concat_to_table().to_pandas()
    ref = rspmd.dist_join(rl, rr, ["k"], ["k"], how).concat_to_table().to_pandas()
    assert list(got.columns) == list(ref.columns)
    want = _pandas_join(jl, jr, how)
    assert len(got) == len(ref) == len(want)
    cols = ["k", "v"] if how in ("semi", "anti") else ["k", "v", "w"]
    _same_rows(got, ref, cols)
    _same_rows(got, want, cols)


def test_fact_dim_join_one_to_many(meshes):
    """tests/test_parallel.py's 1:N expansion: 5 right rows a key."""
    rng = np.random.default_rng(8)
    fact = pd.DataFrame({"k": rng.integers(0, 40, 1200), "v": rng.normal(size=1200)})
    dim = pd.DataFrame({"k": np.repeat(np.arange(40), 5), "w": rng.normal(size=200)})
    (rf, tf), (rd, td) = _sharded(fact, meshes), _sharded(dim, meshes)
    got = tspmd.dist_join(tf, td, ["k"], ["k"]).concat_to_table().to_pandas()
    ref = rspmd.dist_join(rf, rd, ["k"], ["k"]).concat_to_table().to_pandas()
    _same_rows(got, ref, ["k", "v", "w"], rtol=1e-12)
    _same_rows(got, fact.merge(dim, on="k"), ["k", "v", "w"], rtol=1e-12)


def _string_dim_frames():
    """tests/test_parallel.py:166's data: the right side holds keys 10..49
    reversed, so the two sides' dictionaries differ."""
    rng = np.random.default_rng(9)
    keys = np.array([f"key_{i:03d}" for i in range(60)])
    fact = pd.DataFrame({"k": keys[rng.integers(0, 60, 1500)], "v": rng.normal(size=1500)})
    dim = pd.DataFrame({"k": keys[10:50][::-1].copy(), "w": np.arange(40) * 2.0})
    return fact, dim


def test_dist_join_on_strings_with_two_dictionaries_equals_pandas(meshes):
    fact, dim = _string_dim_frames()
    (_, tf), (_, td) = _sharded(fact, meshes), _sharded(dim, meshes)
    got = tspmd.dist_join(tf, td, ["k"], ["k"]).concat_to_table().to_pandas()
    want = fact.merge(dim, on="k")
    assert len(got) == len(want) == 1027
    _same_rows(got, want, ["k", "v", "w"], rtol=1e-12)


def test_reference_dist_join_hashes_string_codes(meshes):
    """Reference fault: ``_shuffle_once`` hashes each table's own
    dictionary codes and the shard probe compares them, so matching keys
    miss each other and rows pair with the wrong ``w`` (998 rows against
    pandas' 1,027)."""
    fact, dim = _string_dim_frames()
    (rf, _), (rd, _) = _sharded(fact, meshes), _sharded(dim, meshes)
    ref = rspmd.dist_join(rf, rd, ["k"], ["k"]).concat_to_table().to_pandas()
    want = fact.merge(dim, on="k")
    assert len(ref) == 998 != len(want)
    wrong = ref.merge(dim, on="k", suffixes=("", "_true"))
    assert (wrong["w"] != wrong["w_true"]).sum() > 0


BROADCAST_CASES = ["numeric", "narrow_string", "two_dictionaries", "left"]


def _broadcast_frames(case):
    rng = np.random.default_rng(6)
    if case == "narrow_string":
        rows = 2048 * 8
        fact = pd.DataFrame({
            "k": np.array([f"grp{i:02d}" for i in range(40)])[rng.integers(0, 40, rows)],
            "v": rng.normal(size=rows)})
        dim = pd.DataFrame({"k": [f"grp{i:02d}" for i in range(40)], "w": np.arange(40.0)})
        return fact, dim
    if case == "two_dictionaries":
        return _string_dim_frames()
    fact = pd.DataFrame({"k": rng.integers(0, 60, 2000), "v": rng.normal(size=2000)})
    dim = pd.DataFrame({"k": np.arange(50), "w": np.arange(50) * 1.5})
    return fact, dim


@pytest.mark.parametrize("case", BROADCAST_CASES)
def test_broadcast_join(meshes, case):
    fact, dim = _broadcast_frames(case)
    how = "left" if case == "left" else "inner"
    rf, tf = _sharded(fact, meshes)
    got = tspmd.broadcast_join(tf, tt.Table.from_pandas(dim, device="cpu"), ["k"], ["k"],
                               how).concat_to_table().to_pandas()
    ref = rspmd.broadcast_join(rf, ct.Table.from_pandas(dim), ["k"], ["k"],
                               how).concat_to_table().to_pandas()
    want = fact.merge(dim, on="k", how=how)
    assert len(got) == len(ref) == len(want)
    for other in (ref, want):
        _same_rows(got, other, ["k", "v", "w"], rtol=1e-12)


@pytest.mark.parametrize("how", ["semi", "anti"])
def test_broadcast_semi_anti(meshes, how):
    jl, jr = _mk(np.random.default_rng(14))
    rl, tl = _sharded(jl, meshes)
    got = tspmd.dist_semi_anti_join(tl, None, ["k"], ["k"], how,
                                    broadcast_right=tt.Table.from_pandas(jr, device="cpu"))
    ref = rspmd.dist_semi_anti_join(rl, None, ["k"], ["k"], how,
                                    broadcast_right=ct.Table.from_pandas(jr))
    for other in (ref.concat_to_table().to_pandas(), _pandas_join(jl, jr, how)):
        _same_rows(got.concat_to_table().to_pandas(), other, ["k", "v"])


# ------------------------------------------------------------------- sort
def _sort_frame(case, rng, n=1700):
    if case == "f64":
        return pd.DataFrame({"k": rng.normal(size=n), "v": np.arange(n)}), ["k"], False, True
    if case == "multikey_desc":
        return (pd.DataFrame({"a": rng.integers(0, 25, n),
                              "b": rng.normal(size=n).astype(np.float32), "v": np.arange(n)}),
                ["a", "b"], [True, False], True)
    if case == "strings":
        return (pd.DataFrame({"s": np.array(["aa", "zz", "mm", "bb"])[rng.integers(0, 4, n)],
                              "x": rng.normal(size=n)}), ["s", "x"], False, True)
    if case == "nan_f64_desc":
        x = rng.normal(size=n)
        x[rng.random(n) < 0.05] = np.nan
        return (pd.DataFrame({"x": x, "g": rng.integers(0, 3, n), "v": np.arange(n)}),
                ["x", "g"], [True, False], True)
    if case == "nan_f32":
        x = rng.normal(size=n).astype(np.float32)
        x[rng.random(n) < 0.05] = np.nan
        return pd.DataFrame({"x": x, "v": np.arange(n)}), ["x"], False, True
    if case == "int64_wide":
        return (pd.DataFrame({"k": rng.integers(-2 ** 62, 2 ** 62, n), "v": np.arange(n)}),
                ["k"], True, True)
    # nulls in an int key and a float key, both placements
    a = pd.array(np.where(rng.random(n) < 0.1, None, rng.integers(0, 9, n)), dtype="Int64")
    b = pd.array(np.where(rng.random(n) < 0.1, None, rng.normal(size=n)), dtype="Float64")
    nl = [True, False] if case == "nulls_mixed" else [False, True]
    return (pd.DataFrame({"a": a, "b": b, "v": np.arange(n)}), ["a", "b"],
            [False, True], nl)


SORT_CASES = ["f64", "multikey_desc", "strings", "nan_f64_desc", "nan_f32", "int64_wide",
              "nulls_mixed", "nulls_first"]


@pytest.mark.parametrize("case", SORT_CASES)
def test_dist_sort_values_equals_sort_by_key(meshes, case):
    df, keys, desc, nl = _sort_frame(case, np.random.default_rng(7))
    rst, tst = _sharded(df, meshes)
    tout = tspmd.dist_sort_values(tst, keys, desc, nl)
    got = tout.concat_to_table().to_pandas()
    whole = tt.Table.from_pandas(df, device="cpu")
    want = tsorting.sort_by_key(whole, keys, desc, nl).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    rout = rspmd.dist_sort_values(rst, keys, desc, nl)
    pd.testing.assert_frame_equal(got, rout.concat_to_table().to_pandas(), check_dtype=False)
    # bit-equal order words give the reference's splitters, so its shard sizes
    assert tout.lengths == [int(x) for x in np.asarray(rout.lengths)]


def _order_words_inputs(rng, n=900):
    f64 = rng.normal(size=n) * 10.0 ** rng.integers(-300, 300, n)
    f64[:20], f64[20:30], f64[30:40], f64[40:50] = np.nan, np.inf, -np.inf, 0.0
    f32 = rng.normal(size=n).astype(np.float32)
    f32[::17] = np.nan
    return pd.DataFrame({
        "a": pd.array(np.where(rng.random(n) < .1, None, rng.integers(0, 25, n)),
                      dtype="Int64"),
        "b": f32, "c": f64, "d": rng.integers(-2 ** 62, 2 ** 62, n),
        "s": rng.choice(["x", "yy", "a", "zz"], n),
        "e": pd.array(np.where(rng.random(n) < .1, None, rng.normal(size=n)),
                      dtype="Float64")})


WORD_KEYS = [["a", "b"], ["c"], ["d", "s"], ["e", "a", "c"], ["b", "c", "d", "e"]]


@pytest.mark.parametrize("keys", WORD_KEYS, ids=["-".join(k) for k in WORD_KEYS])
@pytest.mark.parametrize("flags", ["asc", "desc", "alternate_nulls_first"])
def test_order_words_equal_the_reference(keys, flags):
    """``build_order_words`` holds the reference's u64 bits with the top
    bit flipped; ``sort_payloads_by_words`` and ``lsd_payload_sort`` give
    its permutation."""
    import jax.numpy as jnp

    df = _order_words_inputs(np.random.default_rng(0))
    n = len(df)
    rt, tt_ = ct.Table.from_pandas(df), tt.Table.from_pandas(df, device="cpu")
    desc = {"asc": [False] * len(keys), "desc": [True] * len(keys)}.get(
        flags, [i % 2 == 0 for i in range(len(keys))])
    nl = [flags != "alternate_nulls_first"] * len(keys)
    plan, total = rsorting._sort_code_plan([rt[k] for k in keys], desc, nl)
    kinds, widths = tuple(p[0] for p in plan), tuple(p[2] for p in plan)
    stats = [p[1] for p in plan]
    flags_ = (tuple(s.has_nan for s in stats), tuple(s.has_null for s in stats))
    rw, rtotal = rsorting.build_order_words(
        [rt[k] for k in keys], kinds, widths, tuple(jnp.float64(s.vmin) for s in stats),
        tuple(jnp.int64(s.value_range) for s in stats), *flags_, tuple(desc), tuple(nl), n)
    tw, ttotal = tsorting.build_order_words(
        [tt_[k] for k in keys], kinds, widths, [s.vmin for s in stats],
        [s.value_range for s in stats], *flags_, desc, nl, n)
    assert ttotal == rtotal == total + 1
    for r, t in zip(rw, tw):
        np.testing.assert_array_equal((t.numpy()[:n] ^ np.int64(-2 ** 63)).view(np.uint64),
                                      np.asarray(r)[:n])
    cap = rt[keys[0]].capacity
    pb = max(1, (cap - 1).bit_length())
    rperm = rsorting.sort_payloads_by_words(rw, [jnp.arange(cap, dtype=jnp.int32)], pb,
                                            rtotal)[0]
    tperm = tsorting.sort_payloads_by_words(tw, [torch.arange(cap)], pb, ttotal)[0]
    np.testing.assert_array_equal(tperm.numpy()[:n], np.asarray(rperm)[:n])
    _, rpos, _ = rsortprim.lsd_payload_sort(rw, [])
    tsorted, tpos, (tpay,) = tsortprim.lsd_payload_sort(tw, [torch.arange(cap) * 3])
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(rpos))
    assert torch.equal(tpay, tpos * 3)
    assert all(torch.equal(s, w[tpos]) for s, w in zip(tsorted, tw))


def test_order_words_keep_subnormals_apart_from_zero():
    """The reference's device flushes f64 subnormals to zero in its order
    operands (pinned in test_torch_core.py); the port's words order them
    as ``sort_by_key`` does."""
    x = np.array([5e-324, 0.0, -5e-324, 1e-310, -0.0, 2.2250738585072014e-308])
    t = tt.Table.from_pandas(pd.DataFrame({"x": x}), device="cpu")
    words, _ = tsorting.build_order_words([t["x"]], ("f64",), (67,), (0.0,), (0,),
                                          (False,), (False,), (False,), (True,), len(x))
    perm = tsortprim.multisort_perm(words)[: len(x)].tolist()
    assert perm == tsorting.sorted_order([t["x"]])[: len(x)].tolist() == [2, 1, 4, 0, 3, 5]


# --------------------------------------------- distinct and elementwise
@pytest.mark.parametrize("keep", ["first", "last"])
def test_dist_distinct(meshes, keep):
    rng = np.random.default_rng(17)
    df = pd.DataFrame({"k": rng.integers(0, 25, 3000), "g": rng.integers(0, 3, 3000),
                       "v": np.arange(3000)})
    rst, tst = _sharded(df, meshes)
    got = tspmd.dist_distinct(tst, ["k", "g"], keep).concat_to_table().to_pandas()
    ref = rspmd.dist_distinct(rst, ["k", "g"], keep).concat_to_table().to_pandas()
    want = df.drop_duplicates(["k", "g"], keep=keep)
    for other in (ref, want):
        _same_rows(got, other, ["k", "g", "v"])


def _elementwise_nodes(IR, E):
    return {
        "filter": IR.Filter(E.BinOp("lt", children=(E.Col("v"), E.Literal(0.5))),
                            children=(IR.Empty(),)),
        "select": IR.Select((E.NamedExpr("kk", E.Col("k")),
                             E.NamedExpr("half", E.BinOp("div", children=(
                                 E.Col("v"), E.Literal(2.0))))), children=(IR.Empty(),)),
        "hstack": IR.HStack((E.NamedExpr("v2", E.BinOp("mul", children=(
            E.Col("v"), E.Literal(2.0)))),), children=(IR.Empty(),)),
    }


@pytest.mark.parametrize("node", ["filter", "select", "hstack"])
def test_dist_elementwise(meshes, node):
    rng = np.random.default_rng(16)
    df = pd.DataFrame({"k": rng.integers(0, 9, 3000), "v": rng.normal(size=3000)})
    rst, tst = _sharded(df, meshes)
    got = tspmd.dist_elementwise(tst, _elementwise_nodes(TIR, TE)[node])
    ref = rspmd.dist_elementwise(rst, _elementwise_nodes(RIR, RE)[node])
    got, ref = got.concat_to_table().to_pandas(), ref.concat_to_table().to_pandas()
    assert list(got.columns) == list(ref.columns)
    _same_rows(got, ref)
    assert not tspmd.DIST_FALLBACK_COUNTS


# ------------------------------------------------------------ execute_spmd
def _groupby_plan(IR, E, tbl):
    filt = IR.Filter(E.BinOp("gt", children=(E.Col("v"), E.Literal(0.0))),
                     children=(IR.DataFrameScan(tbl),))
    sel = IR.HStack((E.NamedExpr("v2", E.BinOp("mul", children=(E.Col("v"),
                                                                 E.Literal(2.0)))),),
                    children=(filt,))
    return IR.GroupBy(("k",), (E.NamedExpr("s", E.Agg("sum", children=(E.Col("v2"),))),),
                      children=(sel,))


def test_execute_spmd_gathers_once(meshes, monkeypatch):
    """Filter and HStack between scan and groupby stay on the shards: the
    one gather is the final one."""
    rng = np.random.default_rng(15)
    df = pd.DataFrame({"k": rng.integers(0, 40, 4000), "v": rng.normal(size=4000)})
    calls = {"n": 0}
    orig = tspmd.ShardedTable.concat_to_table

    def counting(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(tspmd.ShardedTable, "concat_to_table", counting)
    plan = _groupby_plan(TIR, TE, tt.Table.from_pandas(df, device="cpu"))
    got = texecute_spmd(plan, mesh=meshes[1]).to_pandas()
    assert calls["n"] == 1
    _same_rows(got, TIR.execute(plan).to_pandas(), ["k", "s"], rtol=1e-9)


def _null_key_groupby(IR, E, Table, kw):
    rng = np.random.default_rng(3)
    k = pd.array(np.where(rng.random(1000) < .1, None, rng.integers(0, 5, 1000)), dtype="Int64")
    df = pd.DataFrame({"k": k, "v": rng.normal(size=1000)})
    return IR.GroupBy(("k",), (E.NamedExpr("s", E.Agg("sum", children=(E.col("v"),))),),
                      children=(IR.DataFrameScan(Table.from_pandas(df, **kw)),))


def test_execute_spmd_groupby_drops_null_keys_as_execute_does(meshes):
    plan = _null_key_groupby(TIR, TE, tt.Table, {"device": "cpu"})
    got = texecute_spmd(plan, mesh=meshes[1]).to_pandas()
    want = TIR.execute(plan).to_pandas()
    assert len(want) == 5 and want["k"].notna().all()
    _same_rows(got, want, ["k", "s"], rtol=1e-9)


def test_reference_execute_spmd_keeps_the_null_key_group(meshes):
    """Reference fault: its execute_spmd maps GroupBy to dist_groupby, whose
    shard body keeps null keys as a group, where its IR.execute drops them."""
    plan = _null_key_groupby(RIR, RE, ct.Table, {})
    got = rexecute_spmd(plan, mesh=meshes[0]).to_pandas()
    want = RIR.execute(plan).to_pandas()
    assert len(got) == len(want) + 1 and got["k"].isna().sum() == 1


@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti"])
def test_execute_spmd_join_hows(meshes, how):
    jl, jr = _mk(np.random.default_rng(18), n=1500)
    plans = [IR.Join(("k",), ("k",), how, children=(
        IR.DataFrameScan(T.from_pandas(jl, **kw)), IR.DataFrameScan(T.from_pandas(jr, **kw))))
        for IR, T, kw in ((RIR, ct.Table, {}), (TIR, tt.Table, {"device": "cpu"}))]
    got = texecute_spmd(plans[1], mesh=meshes[1]).to_pandas()
    ref = rexecute_spmd(plans[0], mesh=meshes[0]).to_pandas()
    for other in (ref, TIR.execute(plans[1]).to_pandas()):
        _same_rows(got, other)


@pytest.fixture(scope="module")
def tpch_tables():
    return {k: tt.Table.from_pandas(v, device="cpu")
            for k, v in tpch.gen_tables(4000).items()}


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6"])
def test_execute_spmd_tpch_equals_execute(meshes, tpch_tables, q):
    plan = getattr(tpch, f"build_{q}")(lambda n: TIR.DataFrameScan(tpch_tables[n]), TE, TIR,
                                       TE.col)
    got = texecute_spmd(plan, mesh=meshes[1]).to_pandas()
    want = TIR.execute(plan).to_pandas()
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    if q in ("q3", "q5", "q1"):
        # the plan sorts: row order exact (q3's top 10, q5's order)
        pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-9)
    else:
        _same_rows(got, want, rtol=1e-9)
    assert not tspmd.DIST_FALLBACK_COUNTS
