"""The port's string ops (``ops/strings.py``) and regex DFA compiler
(``ops/regex_dfa.py``) against cudf_tpu's.

The same values, made from a numpy seed, go through both packages (the
port on the CPU). Codes, dictionaries, flags, counts and null masks must
be equal exactly. A dictionary of at least ``_DEVICE_REGEX_MIN`` values
takes both packages' device lanes (the lockstep DFA, the class-run
extractor, the device token count); a small one takes the host lanes; the
port's launch counters say which lane ran.
"""
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import regex_dfa as rdfa
from cudf_tpu.ops import strings as RS

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import regex_dfa as tdfa
from cudf_tpu_torch.ops import strings as TS

BIG = 12_000  # distinct values: above _DEVICE_REGEX_MIN (8192)


def _values(n_distinct, n_rows, seed):
    """URL-like ASCII values plus edge values ("", newlines, tabs, mixed
    case), and about 3% null rows."""
    rng = np.random.default_rng(seed)
    pool = [f"url/{i:07x}/page" for i in range(n_distinct)]
    pool += ["", "a", "page", "foo bar", "FOO Bar", "a\nb", "a b\tc", "aaabbb", "ab",
             "a_c", "x" * 30, "id=17", " 42 ", "3.5", "-7", "ff", "1.2.3.4", "true",
             "k=v", "a%20b", "ab/cd/ef"]
    vals = np.array(pool, object)[rng.integers(0, len(pool), n_rows)]
    vals[rng.random(n_rows) < 0.03] = None
    return vals


def _pair(vals):
    df = pd.DataFrame({"s": vals})
    return ct.Table.from_pandas(df)["s"], tt.Table.from_pandas(df, device="cpu")["s"]


@pytest.fixture(scope="module")
def cols():
    big = _values(BIG, 30_000, 0)
    small = _values(300, 2_000, 1)
    nonascii = big.copy()
    nonascii[:40] = "ünïcödé/page"
    return {"big": _pair(big), "small": _pair(small), "nonascii": _pair(nonascii)}


def assert_same(got, want):
    """Port column vs reference column: dtype, length, null mask, values,
    and for a string column its dictionary and the codes of valid rows."""
    assert (got.dtype.kind, got.dtype.bits) == (want.dtype.kind, want.dtype.bits)
    n = want.length
    assert got.length == n
    gv = np.ones(n, bool) if got.validity is None else got.validity[:n].numpy()
    wv = np.ones(n, bool) if want.validity is None else np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(gv, wv)
    g, w = got.to_numpy(), want.to_numpy()
    np.testing.assert_array_equal(pd.isna(g), pd.isna(w))
    np.testing.assert_array_equal(g[gv], w[wv])
    if want.dtype.is_string:
        np.testing.assert_array_equal(got.dictionary, want.dictionary)
        np.testing.assert_array_equal(got.data[:n].numpy()[gv], np.asarray(want.data)[:n][wv])


# one entry per ported function: (name, fn(ops module, column))
FUNCS = {
    "lower": lambda S, c: S.lower(c),
    "upper": lambda S, c: S.upper(c),
    "capitalize": lambda S, c: S.capitalize(c),
    "strip": lambda S, c: S.strip(c),
    "slice": lambda S, c: S.slice_strings(c, 1, 6),
    "slice_step": lambda S, c: S.slice_strings(c, None, None, 2),
    "contains_literal": lambda S, c: S.contains(c, "page", regex=False),
    "startswith": lambda S, c: S.startswith(c, "url/00"),
    "endswith": lambda S, c: S.endswith(c, "page"),
    "like": lambda S, c: S.match_like(c, "url/0%_/page"),
    "len": lambda S, c: S.len_strings(c),
    "pad_left": lambda S, c: S.pad(c, 20),
    "pad_both": lambda S, c: S.pad(c, 20, "both", "*"),
    "zfill": lambda S, c: S.zfill(c, 8),
    "repeat": lambda S, c: S.repeat_strings(c, 2),
    "translate": lambda S, c: S.translate(c, {"a": "x", "/": "-"}),
    "wrap": lambda S, c: S.wrap(c, 5),
    "title": lambda S, c: S.title(c),
    "swapcase": lambda S, c: S.swapcase(c),
    "replace": lambda S, c: S.replace_str(c, "page", "P"),
    "replace_regex": lambda S, c: S.replace_str(c, "[0-9]+", "#", regex=True),
    "find": lambda S, c: S.find(c, "/"),
    "rfind": lambda S, c: S.rfind(c, "/"),
    "count_re": lambda S, c: S.count_re(c, "[a-f]"),
    "isalpha": lambda S, c: S.isalpha(c),
    "isdigit": lambda S, c: S.isdigit(c),
    "isalnum": lambda S, c: S.isalnum(c),
    "isspace": lambda S, c: S.isspace(c),
    "isupper": lambda S, c: S.isupper(c),
    "islower": lambda S, c: S.islower(c),
    "isdecimal": lambda S, c: S.isdecimal(c),
    "to_integers": lambda S, c: S.to_integers(c),
    "to_floats": lambda S, c: S.to_floats(c),
    "hex_to_integers": lambda S, c: S.hex_to_integers(c),
    "ipv4_to_integers": lambda S, c: S.ipv4_to_integers(c),
    "to_booleans": lambda S, c: S.to_booleans(c),
    "url_encode": lambda S, c: S.url_encode(c),
    "url_decode": lambda S, c: S.url_decode(c),
}


@pytest.mark.parametrize("size", ["big", "small"])
@pytest.mark.parametrize("name", list(FUNCS))
def test_dictionary_functions_match_reference(cols, name, size):
    rc, tc = cols[size]
    assert_same(FUNCS[name](TS, tc), FUNCS[name](RS, rc))


def test_table_results_match_reference():
    rc, tc = _pair(np.array(["a,b,c", "x", "", None, "k=v=w"], object))
    for want, got in ((RS.split_expand(rc, ","), TS.split_expand(tc, ",")),
                      (RS.split_expand(rc, ",", 1), TS.split_expand(tc, ",", 1)),
                      (RS.partition_strings(rc, "="), TS.partition_strings(tc, "="))):
        assert got.names == want.names
        for name, c in want:
            assert_same(got[name], c)


def test_conversions_from_numbers_match_reference():
    ints = np.array([1, -2, 255, 16909060], np.int64)
    floats = np.array([2.5, np.nan, -1e3], np.float64)
    ri, ti = ct.Column.from_numpy(ints), tt.Column.from_numpy(ints, device="cpu")
    rf, tf = ct.Column.from_numpy(floats), tt.Column.from_numpy(floats, device="cpu")
    assert_same(TS.from_integers(ti), RS.from_integers(ri))
    assert_same(TS.integers_to_hex(ti), RS.integers_to_hex(ri))
    assert_same(TS.integers_to_ipv4(ti), RS.integers_to_ipv4(ri))
    assert_same(TS.from_floats(tf), RS.from_floats(rf))


def test_concat_unify_and_encode_scalar_match_reference(cols):
    (ra, ta), (rb, tb) = cols["small"], _pair(_values(50, 2_000, 7))
    assert_same(TS.concat_strings([ta, tb], "|"), RS.concat_strings([ra, rb], "|"))
    for got, want in zip(TS.unify_dictionaries([ta, tb]), RS.unify_dictionaries([ra, rb])):
        assert_same(got, want)
    for value in ("page", "zzz", ""):
        (gc, gcol), (wc, wcol) = TS.encode_scalar(ta, value), RS.encode_scalar(ra, value)
        assert gc == wc
        assert_same(gcol, wcol)


def test_split_record_needs_list_columns():
    _, tc = _pair(np.array(["a b"], object))
    with pytest.raises(NotImplementedError, match="item 14"):
        TS.split_record(tc)


# ------------------------------------------------------------------ regex
PATTERNS = [r"url/0{2}[0-9a-f]{5}/page", r"page$", r"^url", r"f{3}", r"a+b", r"(a|b)c",
            r"[^a]b", r"\d{3}", r"\w+/\w+", r"a.c", r"^a.*c$", r"x{5,10}", r"(ab)+",
            r"\s", r"^$", r"a\nb", r"foo|bar", r"(?s)a.b", r"(?i)foo", r"\bfoo"]


def _lane_runs(fn):
    before = TS._dfa_steps.launches
    out = fn()
    return out, TS._dfa_steps.launches - before


@pytest.mark.parametrize("size", ["big", "small", "nonascii"])
@pytest.mark.parametrize("pat", PATTERNS)
def test_contains_regex_matches_reference_and_lane(cols, size, pat):
    rc, tc = cols[size]
    got, runs = _lane_runs(lambda: TS.contains(tc, pat, regex=True))
    assert_same(got, RS.contains(rc, pat, regex=True))
    device = size == "big" and tdfa.compile_dfa(pat, anchored=False) is not None
    assert runs == int(device), (pat, size)
    if pat in ("(?i)foo", r"\bfoo"):  # the host lanes: (?i) and \b are not modelled
        assert runs == 0


def test_contains_regex_equals_pandas_on_the_device_lane(cols):
    rc, tc = cols["big"]
    vals = pd.Series(tc.to_numpy())
    for pat in (r"url/0{2}[0-9a-f]{5}/page", r"page$", r"f{3}"):
        got = TS.contains(tc, pat, regex=True).to_numpy()
        want = vals.str.contains(pat, regex=True).to_numpy()
        ok = ~pd.isna(vals).to_numpy()
        np.testing.assert_array_equal(got[ok].astype(bool), want[ok].astype(bool))


def test_wide_dfa_steps_one_byte_at_a_time(cols, monkeypatch):
    """A DFA whose two-step table would pass _MAX_PAIR_TABLE steps one byte
    at a time through its (states x 256) table; the flags are the same."""
    rc, tc = cols["big"]
    monkeypatch.setattr(TS, "_MAX_PAIR_TABLE", 0)
    TS._compiled_dfa.cache_clear()
    TS._DFA_CACHE.clear()
    try:
        for pat in (r"url/0{2}[0-9a-f]{5}/page", r"(ab)+", r"^$"):
            got, runs = _lane_runs(lambda: TS.contains(tc, pat, regex=True))
            assert runs == 1
            assert_same(got, RS.contains(rc, pat, regex=True))
    finally:
        TS._compiled_dfa.cache_clear()
        TS._DFA_CACHE.clear()


EXTRACTS = [r"^url/([0-9a-f]+)/page$", r"^url/([0-9a-f]{2,4})", r"(\d+)", r"([a-z]*)",
            r"url/([0-9a-f]+)/", r"id=(\d+)", r"^([^/]+)/", r"(?i)^(FOO)"]


@pytest.mark.parametrize("size", ["big", "small", "nonascii"])
@pytest.mark.parametrize("pat", EXTRACTS)
def test_extract_re_matches_reference_and_lane(cols, size, pat):
    rc, tc = cols[size]
    before = TS._classrun_kernel.launches
    got = TS.extract_re(tc, pat)
    runs = TS._classrun_kernel.launches - before
    assert_same(got, RS.extract_re(rc, pat))
    device = size == "big" and TS._classrun_plan(pat) is not None
    assert runs == int(device), (pat, size)


def test_the_bench_patterns_take_the_device_lanes(cols):
    """bench.py's regex_hc pattern and the extract shape of the chip smoke."""
    _, tc = cols["big"]
    _, runs = _lane_runs(lambda: TS.contains(tc, r"url/0{3}[0-9a-f]{6}/page"))
    assert runs == 1
    assert TS._classrun_plan(r"^url/([0-9a-f]+)/page$") is not None
    assert TS._classrun_plan(r"url/([0-9a-f]+)/page") is None  # unanchored: host re


def test_dictionary_byte_matrix_equals_reference(cols):
    for size in ("big", "small", "nonascii"):
        rc, tc = cols[size]
        want = RS._dict_host_bytes(RS._dict_values(rc))
        got = TS._dict_host_bytes(TS._dict_values(tc))
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
            mat = TS._dict_device_bytes(TS._dict_values(tc), tc.device)
            np.testing.assert_array_equal(mat.numpy(), got.T)


@pytest.mark.parametrize("pat", PATTERNS + [r"^url/([0-9a-f]+)/page$", r"[\x80-\xff]",
                                            "é+", r"a{40}", "(?m)^a"])
def test_compile_dfa_tables_equal_reference(pat):
    for anchored in (False, True):
        want, got = rdfa.compile_dfa(pat, anchored), tdfa.compile_dfa(pat, anchored)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        cmap, C = tdfa.byte_classes(got)
        rcmap, rC = rdfa.byte_classes(want)
        np.testing.assert_array_equal(cmap, rcmap)
        assert C == rC
        if got.shape[0] <= 64 and C <= 16:
            P, width = tdfa.pair_table(got, cmap, C)
            RP, rwidth = rdfa.pair_table(want, rcmap, rC)
            np.testing.assert_array_equal(P, RP)
            assert width == rwidth
            # the port's int32 two-step table is the one-hot rows decoded
            np.testing.assert_array_equal(tdfa.pair_steps(got, cmap, C), P.argmax(axis=1))
        strings = [f"url/{i:07x}/page" for i in range(50)] + [
            "", "a", "foo bar", "a\nb", "aaabbb", "x" * 41, "ab" * 5]
        np.testing.assert_array_equal(tdfa.dfa_match_host(got, strings),
                                      rdfa.dfa_match_host(want, strings))


def test_mandatory_literal_and_classrun_plan_equal_reference():
    for pat in PATTERNS + EXTRACTS + ["url/0{3}", "(?i)foobar", "ab"]:
        assert TS._mandatory_literal(pat) == RS._mandatory_literal(pat)
        assert TS._classrun_plan(pat) == RS._classrun_plan(pat)


@pytest.mark.parametrize("vals", [np.array([], object), np.array([None, None], object),
                                  np.array(["", None, ""], object)])
def test_empty_and_null_columns_match_reference(vals):
    rc, tc = _pair(vals)
    for name in ("len", "upper", "startswith", "find", "to_integers"):
        assert_same(FUNCS[name](TS, tc), FUNCS[name](RS, rc))
    assert_same(TS.contains(tc, "a+", regex=True), RS.contains(rc, "a+", regex=True))
    assert_same(TS.extract_re(tc, r"(\d+)"), RS.extract_re(rc, r"(\d+)"))
