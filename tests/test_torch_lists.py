"""The port's nested types (``core/lists.py``, ``core/structs.py``,
``ops/list_ops.py``) and the list-valued string ops, explode and
COLLECT_LIST against cudf_tpu's and pandas.

The same rows, made from a numpy seed, go through both packages (the port
on the CPU). Tolerance: exact everywhere (offsets, lengths, children,
codes, masks, row orders). The reference pads a list's offsets to a
capacity bucket and the port does not, so lists are compared through
``to_pylist`` and the flat child.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.core import lists as RL
from cudf_tpu.core.structs import StructColumn as RStruct
from cudf_tpu.expr import ir as RIR
from cudf_tpu.ops import list_ops as RO
from cudf_tpu.ops import strings as RS
from cudf_tpu.ops import text as RT

import cudf_tpu_torch as tt
from cudf_tpu_torch.core import lists as TL
from cudf_tpu_torch.core.structs import StructColumn as TStruct
from cudf_tpu_torch.expr import ir as TIR
from cudf_tpu_torch.ops import list_ops as TO
from cudf_tpu_torch.ops import strings as TS
from cudf_tpu_torch.ops import text as TT


def _py(rows):
    """Host lists with numpy scalars made Python values (None stays)."""
    return [None if r is None else [x.item() if hasattr(x, "item") else x for x in r]
            for r in rows]


def _same(got, want):
    """Equal arrays, a null (None or NaN) where the other has one."""
    gn, wn = pd.isna(got), pd.isna(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got[~gn], want[~wn])


def _rows(kind, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        k = int(rng.integers(0, 6))
        if kind == "int":
            out.append([int(v) for v in rng.integers(-3, 4, k)])
        elif kind == "float":
            out.append([float(v) for v in np.round(rng.normal(size=k), 1)])
        else:
            out.append([str(v) for v in rng.choice(["a", "bb", "c", "dd", "é"], k)])
    return out


def _pair(rows):
    return RL.ListColumn.from_pylist(rows), TL.ListColumn.from_pylist(rows, device="cpu")


KINDS = ["int", "float", "str"]


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_lengths_extract_explode(kind):
    rows = _rows(kind, 300, 1)
    r, t = _pair(rows)
    assert _py(t.to_pylist()) == _py(r.to_pylist()) == rows
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(r.offsets)[: r.length + 1])
    _same(t.lengths().to_numpy(), r.lengths().to_numpy())
    for i in (0, 1, 4, -1, -2):
        _same(t.extract(i).to_numpy(), r.extract(i).to_numpy())
    (rp, rc), (tp, tc) = r.explode(), t.explode()
    np.testing.assert_array_equal(tp.to_numpy(), rp.to_numpy())
    np.testing.assert_array_equal(tc.to_numpy(), rc.to_numpy())


def test_list_valued_pandas_cells_ingest_as_the_reference():
    df = pd.DataFrame({"l": [[1, 2], None, [3], [1, 2], [], np.nan, (3,)],
                       "x": np.arange(7)})
    r, t = ct.Table.from_pandas(df)["l"], tt.Table.from_pandas(df, device="cpu")["l"]
    assert (t.dtype.kind, t.dtype.param) == (r.dtype.kind, r.dtype.param)
    np.testing.assert_array_equal(t.data[:7].numpy(), np.asarray(r.data)[:7])
    np.testing.assert_array_equal(t.validity[:7].numpy(), np.asarray(r.validity)[:7])
    assert [list(c) for c in t.dictionary] == [list(c) for c in r.dictionary]
    got = tt.Table.from_pandas(df, device="cpu").to_pandas()["l"].tolist()
    assert [None if v is None else list(v) for v in got] == \
        [[1, 2], None, [3], [1, 2], [], None, [3]]


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(3)
    pool = [f"w{i}/x{i % 7}/{'y' * (i % 3)}" for i in range(40)] + ["", "/", "a//b", "plain"]
    vals = np.array(pool, object)[rng.integers(0, len(pool), 500)]
    vals[rng.random(500) < 0.05] = None
    df = pd.DataFrame({"s": vals})
    return vals, ct.Table.from_pandas(df)["s"], tt.Table.from_pandas(df, device="cpu")["s"]


@pytest.mark.parametrize("maxsplit", [-1, 0, 1])
def test_split_record_matches_reference_and_python(words, maxsplit):
    vals, r, t = words
    got = TS.split_record(t, "/", maxsplit)
    assert got.to_pylist() == RS.split_record(r, "/", maxsplit).to_pylist()
    assert got.to_pylist() == [None if v is None else v.split("/", maxsplit) for v in vals]


def test_wordpiece_matches_reference():
    vocab = ["[UNK]", "un", "##aff", "##able", "hello", "world", "##s", "w", "##1"]
    vals = np.array(["unaffable", "hello worlds", "xyz", None, "", "w1 w11 hello"] * 20,
                    object)
    df = pd.DataFrame({"s": vals})
    r = RT.wordpiece_tokenize(ct.Table.from_pandas(df)["s"], RT.WordPieceVocabulary(vocab), 3)
    t = TT.wordpiece_tokenize(tt.Table.from_pandas(df, device="cpu")["s"],
                              TT.WordPieceVocabulary(vocab), 3)
    assert _py(t.to_pylist()) == _py(r.to_pylist())
    assert _py(t.to_pylist()[:3]) == [[1, 2, 3], [4, 5, 6], [0]]


def test_groupby_collect_matches_reference_and_pandas():
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"k": rng.integers(0, 30, 1000), "g": rng.integers(0, 2, 1000),
                       "v": rng.normal(size=1000)})
    rk, rlists = RL.groupby_collect(ct.Table.from_pandas(df), ["k", "g"], "v")
    tk, tlists = TL.groupby_collect(tt.Table.from_pandas(df, device="cpu"), ["k", "g"], "v")
    for k in ("k", "g"):
        np.testing.assert_array_equal(tk[k].to_numpy(), rk[k].to_numpy())
    assert _py(tlists.to_pylist()) == _py(rlists.to_pylist())
    want = df.groupby(["k", "g"], sort=True)["v"].agg(list)
    assert _py(tlists.to_pylist()) == [list(v) for v in want]


# ---------------------------------------------------------------- explode
def _frame_pair(pdf):
    return ct.DataFrame.from_pandas(pdf), tt.DataFrame(pdf, device="cpu")


def test_frame_explode_follows_pandas_with_the_index():
    pdf = pd.DataFrame({"A": [[1, 2], 3.5, [], None, [4], [5, 6, 7]],
                        "B": [10, 20, 30, 40, 50, 60]}, index=list("abcdef"))
    got = tt.DataFrame(pdf, device="cpu").explode("A").to_pandas()
    want = pdf.explode("A")
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got["A"].astype(float), want["A"].astype(float))
    np.testing.assert_array_equal(got["B"], want["B"])
    ig = tt.DataFrame(pdf, device="cpu").explode("A", ignore_index=True).to_pandas()
    assert list(ig.index) == list(range(len(want)))


def test_reference_explode_drops_the_index():
    """The reference's DataFrame.explode numbers its rows afresh; pandas
    (and the port) repeat each row's label."""
    pdf = pd.DataFrame({"A": [[1, 2], [3]], "B": [1, 2]}, index=[7, 9])
    ref = ct.DataFrame.from_pandas(pdf).explode("A").to_pandas()
    assert list(ref.index) == [0, 1, 2] != list(pdf.explode("A").index)
    got = tt.DataFrame(pdf, device="cpu").explode("A").to_pandas()
    assert list(got.index) == [7, 7, 9]


@pytest.mark.parametrize("cells", ["strings", "ints"])
def test_explode_matches_reference_values(cells):
    rows = _rows("str" if cells == "strings" else "int", 200, 6)
    pdf = pd.DataFrame({"L": pd.Series(rows, dtype=object), "n": np.arange(200)})
    r, t = _frame_pair(pdf)
    rg, tg = r.explode("L").to_pandas(), t.explode("L").to_pandas()
    want = pdf.explode("L")
    np.testing.assert_array_equal(tg["n"], rg["n"])
    np.testing.assert_array_equal(tg["n"], want["n"])
    np.testing.assert_array_equal(pd.isna(tg["L"]), pd.isna(want["L"]))
    keep = ~pd.isna(want["L"]).to_numpy()
    np.testing.assert_array_equal(tg["L"].to_numpy()[keep].astype(str),
                                  want["L"].to_numpy()[keep].astype(str))


def test_series_split_and_explode_follow_pandas(words):
    vals, _, _ = words
    s = pd.Series(vals, name="s", index=np.arange(len(vals)) * 3)
    ts = tt.Series(s, device="cpu")
    got = ts.str.split("/").to_pandas()
    want = s.str.split("/")
    assert ts.str.split("/").dtype == np.dtype(object) and len(ts.str.split("/")) == len(s)
    assert [None if v is None else list(v) for v in got] == \
        [None if not isinstance(v, list) else v for v in want]
    ge, we = ts.str.split("/").explode().to_pandas(), want.explode()
    assert list(ge.index) == list(we.index)
    np.testing.assert_array_equal(pd.isna(ge).to_numpy(), pd.isna(we).to_numpy())
    m = ~pd.isna(we).to_numpy()
    np.testing.assert_array_equal(ge.to_numpy()[m], we.to_numpy()[m])
    assert ts.str.split("/", n=1).to_pandas().tolist()[0] == s.str.split("/", n=1).tolist()[0]


def test_ir_explode_matches_reference():
    """The port's MapFunction explode, on a ListColumn and on list cells
    ingested from pandas, equals the reference's ListColumn.explode (the
    cudf semantics: an empty or null list gives no row)."""
    rows = _rows("int", 100, 7)
    rp, rc = RL.ListColumn.from_pylist(rows).explode()
    want_k, want_l = rp.to_numpy(), rc.to_numpy()
    ttbl = tt.Table({"k": tt.Column.from_numpy(np.arange(100), device="cpu"),
                     "L": TL.ListColumn.from_pylist(rows, device="cpu")})
    cells = tt.Table.from_pandas(pd.DataFrame({"k": np.arange(100),
                                               "L": pd.Series(rows, dtype=object)}),
                                 device="cpu")
    for tbl in (ttbl, cells):
        t = TIR.execute(TIR.MapFunction("explode", ("L",), children=(TIR.DataFrameScan(tbl),)))
        np.testing.assert_array_equal(t["k"].to_numpy(), want_k)
        np.testing.assert_array_equal(t["L"].to_numpy().astype(np.int64), want_l)


def test_reference_ir_explode_cannot_run():
    """The reference's MapFunction explode needs a ListColumn in a Table,
    which its Table cannot hold, and its ingest gives list cells, which the
    node refuses; the port runs both (above)."""
    with pytest.raises(AttributeError):
        ct.Table({"L": RL.ListColumn.from_pylist([[1]])})
    cells = ct.Table.from_pandas(pd.DataFrame({"L": pd.Series([[1, 2], [3]], dtype=object)}))
    with pytest.raises(AssertionError):
        RIR.execute(RIR.MapFunction("explode", ("L",), children=(RIR.DataFrameScan(cells),)))


# ---------------------------------------------------------------- list ops
@pytest.mark.parametrize("kind", KINDS)
def test_contains_unique_sort_match_reference(kind):
    rows = _rows(kind, 300, 8)
    r, t = _pair(rows)
    probe = {"int": 2, "float": 0.5, "str": "bb"}[kind]
    _same(TO.list_contains(t, probe).to_numpy(), RO.list_contains(r, probe).to_numpy())
    missing = {"int": 99, "float": 9.5, "str": "zz"}[kind]
    assert not np.nan_to_num(TO.list_contains(t, missing).to_numpy().astype(float)).any()
    assert _py(TO.list_unique(t).to_pylist()) == _py(RO.list_unique(r).to_pylist())
    for desc in (False, True):
        assert _py(TO.list_sort(t, desc).to_pylist()) == _py(RO.list_sort(r, desc).to_pylist())
    assert _py(TO.list_unique(t).to_pylist()) == \
        [None if v is None else sorted(set(v)) for v in rows]


def test_list_contains_with_null_elements():
    """The reference pairs its child's null-flag operand with the target's
    value operand, so a list whose child has a mask never contains the
    value; the port compares values (lists::contains)."""
    rows = [[1, 2], [3], [2, 5]]
    r, t = _pair(rows)
    masked_r = RL.ListColumn(r.offsets, ct.Column(r.child.dtype, r.child.data,
                                                  np.arange(r.child.capacity) != 1,
                                                  r.child.length), r.length)
    child = t.child
    import torch

    masked_t = TL.ListColumn(t.offsets, tt.Column(child.dtype, child.data,
                                                  torch.arange(child.capacity) != 1,
                                                  child.length), t.length)
    np.testing.assert_array_equal(TO.list_contains(masked_t, 2).to_numpy(),
                                  [False, False, True])
    assert not RO.list_contains(masked_r, 2).to_numpy().any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["union", "intersect", "difference", "overlap"])
def test_set_ops_match_reference(kind, op):
    a_rows = [r if r is not None else [] for r in _rows(kind, 200, 9)]
    b_rows = [r if r is not None else [] for r in _rows(kind, 200, 10)]
    ra, ta = _pair(a_rows)
    rb, tb = _pair(b_rows)
    fr, ft = getattr(RO, f"list_{op}"), getattr(TO, f"list_{op}")
    if op == "overlap":
        np.testing.assert_array_equal(ft(ta, tb).to_numpy(), fr(ra, rb).to_numpy())
        want = [bool(set(a) & set(b)) for a, b in zip(a_rows, b_rows)]
        np.testing.assert_array_equal(ft(ta, tb).to_numpy(), want)
        return
    assert _py(ft(ta, tb).to_pylist()) == _py(fr(ra, rb).to_pylist())
    py = {"union": lambda a, b: a | b, "intersect": lambda a, b: a & b,
          "difference": lambda a, b: a - b}[op]
    assert _py(ft(ta, tb).to_pylist()) == [sorted(py(set(a), set(b)))
                                           for a, b in zip(a_rows, b_rows)]


def test_set_ops_on_string_children_with_two_dictionaries():
    ra, ta = _pair([["x", "y"], ["p"], []])
    rb, tb = _pair([["y", "z"], ["q", "p"], ["k"]])
    assert list(ta.child.dictionary) != list(tb.child.dictionary)
    for op in ("union", "intersect", "difference"):
        got = getattr(TO, f"list_{op}")(ta, tb).to_pylist()
        assert got == getattr(RO, f"list_{op}")(ra, rb).to_pylist()
    assert TO.list_union(ta, tb).to_pylist() == [["x", "y", "z"], ["p", "q"], ["k"]]


# ---------------------------------------------------------------- structs
def test_structs_match_reference():
    rows = [{"a": 1, "b": "x"}, None, {"a": None, "b": "y"}, {"a": 4, "b": None}]
    r, t = RStruct.from_pydict_rows(rows), TStruct.from_pydict_rows(rows, device="cpu")
    assert t.length == r.length == 4
    for k in ("a", "b"):
        a, b = t.field(k).to_numpy(), r.field(k).to_numpy()
        np.testing.assert_array_equal(pd.isna(a), pd.isna(b))
        np.testing.assert_array_equal(a[~pd.isna(a)], b[~pd.isna(b)])
    tl, rl = t.to_pylist(), r.to_pylist()
    assert tl[1] is None and rl[1] is None
    assert [k.length for k in t.key_columns()] == [4, 4]
    assert tl[0] == {"a": 1, "b": "x"} and pd.isna(tl[2]["a"]) and tl[3]["b"] is None
