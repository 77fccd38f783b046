"""The port's text ops (``ops/text.py``) and JSON path extraction
(``ops/json_ops.py``) against cudf_tpu's.

The same values, made from a numpy seed, go through both packages (the
port on the CPU); results must be equal exactly: values, null masks,
counts. ``count_tokens`` takes the device lane on a dictionary of at least
1024 values and the host lane below it; ``count_tokens("")`` is 0 in both,
nvtext's convention.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import json_ops as RJ
from cudf_tpu.ops import text as RT

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import json_ops as TJ
from cudf_tpu_torch.ops import text as TT


def _pair(vals):
    df = pd.DataFrame({"s": vals})
    return ct.Table.from_pandas(df)["s"], tt.Table.from_pandas(df, device="cpu")["s"]


def _words(n_distinct, n_rows, seed, ascii_only=False):
    """Space-separated words, "" and delimiter edge values, 5% null rows;
    one non-ASCII word unless ``ascii_only`` (the device lane needs ASCII)."""
    rng = np.random.default_rng(seed)
    words = np.array(["the", "quick", "fox", "a", "b", "ccc", "hello", "world"]
                     + ([] if ascii_only else ["héllo"]))
    pool = [" ".join(words[rng.integers(0, len(words), rng.integers(1, 6))])
            + f" w{i}" for i in range(n_distinct)]
    pool += ["", "a", "hellohello world", "a  b", "x/y/z", "/", "//a/"]
    vals = np.array(pool, object)[rng.integers(0, len(pool), n_rows)]
    vals[rng.random(n_rows) < 0.05] = None
    return vals


@pytest.fixture(scope="module")
def cols():
    return {"big": _pair(_words(2000, 5000, 0, ascii_only=True)),
            "small": _pair(_words(40, 300, 1))}


def assert_same(got, want):
    assert (got.dtype.kind, got.dtype.bits) == (want.dtype.kind, want.dtype.bits)
    assert got.length == want.length
    g, w = got.to_numpy(), want.to_numpy()
    gn, wn = pd.isna(pd.Series(g)).to_numpy(), pd.isna(pd.Series(w)).to_numpy()
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(g[~gn], w[~wn])


@pytest.mark.parametrize("size", ["big", "small"])
@pytest.mark.parametrize("delim", [" ", "/", "o"])
def test_count_tokens_matches_reference_and_lane(cols, size, delim):
    rc, tc = cols[size]
    before = TT._count_tokens_device.launches
    got = TT.count_tokens(tc, delim)
    assert TT._count_tokens_device.launches - before == (size == "big")
    assert_same(got, RT.count_tokens(rc, delim))


@pytest.mark.parametrize("lane", ["device", "host"])
def test_count_tokens_of_empty_string_is_zero(lane):
    vals = np.array([f"v{i} x" for i in range(1100 if lane == "device" else 3)]
                    + ["", "a", "a b"], object)
    rc, tc = _pair(vals)
    got = TT.count_tokens(tc, " ").to_numpy()
    assert list(got[-3:]) == [0, 1, 2]
    assert_same(TT.count_tokens(tc, " "), RT.count_tokens(rc, " "))


FUNCS = {
    "tokenize": lambda T, c: T.tokenize(c, " "),
    "character_ngrams": lambda T, c: T.character_ngrams(c, 3),
    "ngrams_tokenize": lambda T, c: T.ngrams_tokenize(c, 2),
    "generate_ngrams": lambda T, c: T.generate_ngrams(c, 2, "-"),
    "normalize_spaces": lambda T, c: T.normalize_spaces(c),
    "porter_stem": lambda T, c: T.porter_stem(c),
    "replace_tokens": lambda T, c: T.replace_tokens(c, ["the", "a"], ["THE", "A"]),
    "filter_tokens": lambda T, c: T.filter_tokens(c, 3),
    "filter_tokens_replace": lambda T, c: T.filter_tokens(c, 3, "_"),
    "normalize_characters": lambda T, c: T.normalize_characters(c),
    "deduplicate": lambda T, c: T.deduplicate(c, 5),
    "byte_pair_encode": lambda T, c: T.byte_pair_encode(
        c, T.BPEMergePairs(["t h", "th e", "h e", "l l", "ll o"])),
}


@pytest.mark.parametrize("name", list(FUNCS))
def test_text_functions_match_reference(cols, name):
    rc, tc = cols["small"]
    assert_same(FUNCS[name](TT, tc), FUNCS[name](RT, rc))


def test_minhash_jaccard_edit_distance_match_reference(cols):
    rc, tc = cols["small"]
    rt, tt_ = RT.minhash(rc, seeds=(0, 5), width=3), TT.minhash(tc, seeds=(0, 5), width=3)
    assert tt_.names == rt.names
    for name, c in rt:
        assert_same(tt_[name], c)
    rb, tb = _pair(_words(40, 300, 2))
    assert_same(TT.jaccard_index(tc, tb, 3), RT.jaccard_index(rc, rb, 3))
    assert_same(TT.edit_distance(tc, tb), RT.edit_distance(rc, rb))


def test_reference_cases():
    """tests/test_long_tail.py's nvtext cases."""
    _, c = _pair(np.array(["the quick fox", "a b ccc"], object))
    assert list(TT.replace_tokens(c, ["the", "a"], ["THE", "A"]).to_numpy()) == \
        ["THE quick fox", "A b ccc"]
    assert list(TT.filter_tokens(c, 3).to_numpy()) == ["the quick fox", "ccc"]
    _, c = _pair(np.array(["Héllo   World"], object))
    assert list(TT.normalize_characters(c).to_numpy()) == ["hello world"]
    _, c = _pair(np.array(["a b c", "x y"], object))
    assert list(TT.ngrams_tokenize(c, 2).to_numpy()) == ["a_b", "b_c", "x_y"]
    _, c = _pair(np.array(["hellohello world", "abcdef"], object))
    assert list(TT.deduplicate(c, min_width=5).to_numpy()) == ["hello world", "abcdef"]


def test_wordpiece_needs_list_columns():
    """wordpiece_tokenize raised until list columns were ported; it now
    returns a ListColumn equal to the reference's."""
    r, c = _pair(np.array(["hello", "hello hello", None], object))
    got = TT.wordpiece_tokenize(c, TT.WordPieceVocabulary(["hello"])).to_pylist()
    want = RT.wordpiece_tokenize(r, RT.WordPieceVocabulary(["hello"])).to_pylist()
    assert [None if v is None else [int(x) for x in v] for v in got] == \
        [None if v is None else [int(x) for x in v] for v in want] == [[0], [0, 0], None]


# -------------------------------------------------------------- JSON path
JSON_VALUES = np.array([
    '{"a": {"b": 1}, "c": "x"}', '{"a": {"b": 2.5}}', '{"c": "y"}', "not json",
    '{"items": [{"v": 10}, {"v": 20}]}', '{"items": []}', '{"a b": [1, 2, 3]}',
    '{"t": true, "n": null, "o": {"k": [1, {"z": "w"}]}}', None], object)
PATHS = ["$.a.b", "$.c", "$.items[1].v", "$.items[*].v", "$.items[0]",
         "$['a b'][-1]", "$.t", "$.n", "$.o", "$.o.k[1].z", "$.*", "$"]


@pytest.mark.parametrize("path", PATHS)
def test_get_json_path_matches_reference(path):
    rc, tc = _pair(JSON_VALUES)
    assert_same(TJ.get_json_path(tc, path), RJ.get_json_path(rc, path))


def test_get_json_path_reference_cases():
    """tests/test_json_avro_subword.py's cases."""
    _, c = _pair(np.array(['{"a": {"b": 1}, "c": "x"}', '{"a": {"b": 2.5}}',
                           '{"c": "y"}', "not json"], object))
    assert list(TJ.get_json_path(c, "$.a.b").to_numpy()) == ["1", "2.5", None, None]
    assert list(TJ.get_json_path(c, "$.c").to_numpy()) == ["x", None, "y", None]
    _, c = _pair(np.array(['{"items": [{"v": 10}, {"v": 20}]}', '{"items": []}'], object))
    assert list(TJ.get_json_path(c, "$.items[1].v").to_numpy()) == ["20", None]
    assert list(TJ.get_json_path(c, "$.items[*].v").to_numpy()) == ["[10,20]", None]
    assert list(TJ.get_json_path(c, "$.items[0]").to_numpy()) == ['{"v":10}', None]
    with pytest.raises(ValueError):
        TJ.get_json_path(c, "a.b")
