"""String column utilities (counterpart of ``cudf_tpu/ops/strings.py``).

Strings are dictionary-encoded: device buffers hold int32 codes into a
host-side *sorted* array of unique values, so comparisons, sorts and joins
on strings are integer problems once both sides share one dictionary.
Value-level work runs once per distinct value, on the dictionary, and the
result comes back to the rows through one device gather of the codes.

The device parts are the reference's, in torch:

  * the code remap gather (``_table_gather``);
  * the dictionary byte matrix (``_dict_host_bytes``/``_dict_device_bytes``),
    an (L, n) u8 tensor of the dictionary's ASCII bytes with one sentinel
    column, L from the longest value;
  * the lockstep DFA (``_dfa_steps``): every value advances through a
    host-compiled byte DFA (``ops/regex_dfa.py``) in lockstep, one gather a
    step. The reference steps two characters at a time with one-hot rows
    and an argmax, because row gathers are cheap on its accelerator; here a
    step is a scalar gather, two characters at a time through an int32
    table over byte-class pairs (``regex_dfa.pair_steps``) when the DFA is
    small, one byte at a time otherwise;
  * the class-run extractor (``_classrun_kernel``), whose output is
    deduplicated on the device (``_unique_rows``) instead of by a host
    sort of every extracted value.

Lane order, the ``_DEVICE_REGEX_MIN`` threshold and the host fallbacks
(non-ASCII, ``(?i)``, more than 250 DFA states, constructs the DFA does not
model) are the reference's: they decide which answers the device gives.
``_dfa_steps.launches``, ``_classrun_kernel.launches`` and
``text._count_tokens_device.launches`` count the device lanes' runs.
The dictionary caches are kept, with their (reference, value) identity
check: ``id()`` is reused once an object dies.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table


def _table_gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[codes], codes clamped into the table (padding rows hold 0)."""
    return table.index_select(0, codes.clamp(0, table.shape[0] - 1))


def _host_table(values: np.ndarray, col: Column) -> torch.Tensor:
    """A per-dictionary-value host table on the column's device (one row
    when the dictionary is empty, so the gather stays in bounds)."""
    if not len(values):
        values = np.zeros((1,), values.dtype)
    return torch.from_numpy(np.ascontiguousarray(values)).to(col.device)


def _remap_codes(col: Column, remap: np.ndarray, new_dict: np.ndarray) -> Column:
    """Gather codes through a host-computed remap table (device gather)."""
    data = col.data
    if len(remap):
        data = _table_gather(_host_table(remap.astype(np.int32), col), data)
    return Column(col.dtype, data, col.validity, col.length, new_dict)


def unify_dictionaries(cols: List[Column]) -> List[Column]:
    """Recode string columns onto the union dictionary (sorted)."""
    dicts = [c.dictionary if c.dictionary is not None else np.array([], dtype=str)
             for c in cols]
    if all(d is dicts[0] or (len(d) == len(dicts[0]) and (d == dicts[0]).all())
           for d in dicts[1:]):
        return list(cols)
    merged = np.unique(np.concatenate([d.astype(str) for d in dicts]))
    return [_remap_codes(c, np.searchsorted(merged, d.astype(str)), merged)
            for c, d in zip(cols, dicts)]


def align_string_operands(lhs: Column, rhs: Column) -> Tuple[Column, Column]:
    l, r = unify_dictionaries([lhs, rhs])
    return l, r


def encode_scalar(col: Column, value: str) -> Tuple[int, Column]:
    """(code, possibly recoded column) such that code is value's slot."""
    d = col.dictionary if col.dictionary is not None else np.array([], dtype=str)
    pos = int(np.searchsorted(d, value))
    if pos < len(d) and d[pos] == value:
        return pos, col
    new_dict = np.insert(d, pos, value)
    remap = np.searchsorted(new_dict, d).astype(np.int32)
    return pos, _remap_codes(col, remap, new_dict)


# ---- value-level ops (computed on the dictionary, host-side numpy) ---------
_DICT_STR_CACHE: dict = {}  # id(dictionary) -> (ref, str ndarray)


def _dict_values(col: Column) -> np.ndarray:
    """str-typed view of the column's dictionary, cached per dictionary
    object: the caches below key on id() of this array, so it must be
    stable (a str dictionary is its own view, with no copy)."""
    d = col.dictionary
    if d is None:
        return np.array([], dtype=str)
    hit = _DICT_STR_CACHE.get(id(d))
    if hit is not None and hit[0] is d:
        return hit[1]
    v = d if d.dtype.kind == "U" else d.astype(str)
    if len(_DICT_STR_CACHE) > 64:
        _DICT_STR_CACHE.clear()
    _DICT_STR_CACHE[id(d)] = (d, v)
    return v


def _from_new_values(col: Column, new_vals: np.ndarray) -> Column:
    """Rebuild a string column whose dictionary values were transformed."""
    new_vals = np.asarray(new_vals).astype(str)
    uniq, inv = (np.unique(new_vals, return_inverse=True) if len(new_vals)
                 else (new_vals, np.array([], np.int64)))
    return _remap_codes(col, inv.reshape(-1).astype(np.int32), uniq)


def _dict_map(col: Column, fn) -> Column:
    """Host fn over dictionary values, one Python call a value (prefer the
    vectorized ``_dict_map_vec``)."""
    new_vals = np.array([fn(x) for x in _dict_values(col)], dtype=object)
    return _from_new_values(col, new_vals)


def _dict_map_vec(col: Column, vec_fn) -> Column:
    """Vectorized (np.char / pandas .str) transform over dictionary values."""
    d = _dict_values(col)
    return _from_new_values(col, vec_fn(d) if len(d) else d)


def lower(col: Column) -> Column:
    return _dict_map_vec(col, np.char.lower)


def upper(col: Column) -> Column:
    return _dict_map_vec(col, np.char.upper)


def capitalize(col: Column) -> Column:
    return _dict_map_vec(col, np.char.capitalize)


def strip(col: Column) -> Column:
    return _dict_map_vec(col, np.char.strip)


def slice_strings(col: Column, start=None, stop=None, step=None) -> Column:
    from ..utils.real_pandas import pd

    return _dict_map_vec(
        col, lambda d: pd.Series(d).str.slice(start, stop, step).to_numpy())


def _dict_predicate(col: Column, fn) -> Column:
    """Per-value predicate fallback -> bool column via code gather."""
    d = _dict_values(col)
    flags = np.array([bool(fn(x)) for x in d], dtype=bool)
    return _dict_flags(col, flags)


def _dict_flags(col: Column, flags: np.ndarray) -> Column:
    out = _table_gather(_host_table(np.asarray(flags, bool), col), col.data)
    return Column(dtypes.bool_, out, col.validity, col.length)


def _dict_predicate_vec(col: Column, vec_fn) -> Column:
    """Vectorized (np.char) predicate over dictionary values."""
    d = _dict_values(col)
    flags = np.asarray(vec_fn(d), bool) if len(d) else np.zeros((0,), bool)
    return _dict_flags(col, flags)


_PA_DICT_CACHE: dict = {}  # id(dictionary) -> (dictionary ref, pa.Array)


def _dict_arrow(d: np.ndarray):
    """Cached pyarrow view of an (immutable) string dictionary: the arrow
    conversion costs more than the regex itself, so pay it once."""
    import pyarrow as pa

    key = id(d)
    hit = _PA_DICT_CACHE.get(key)
    if hit is not None and hit[0] is d:
        return hit[1]
    arr = pa.array(np.asarray(d, dtype=object), type=pa.string())
    if len(_PA_DICT_CACHE) > 64:
        _PA_DICT_CACHE.clear()
    _PA_DICT_CACHE[key] = (d, arr)
    return arr


def _mandatory_literal(pat: str):
    """(literal, anchored): a literal substring every match must contain,
    or None. The same optimization CPython's ``re`` applies internally
    (literal-prefix scan) and RE2 applies via required-prefix analysis:
    walk the parse tree's top-level concatenation and take the longest run
    of fixed literals. ``anchored`` is True when the run starts the pattern
    (usable as a prefix test)."""
    import re

    try:
        parser = getattr(re, "_parser", None) or __import__("sre_parse")
        tree = parser.parse(pat)
    except Exception:
        return None
    # inline (?i) lands on tree.state.flags, not in the node list: a
    # case-sensitive literal prefilter would drop case-insensitive matches
    if getattr(getattr(tree, "state", None), "flags", 0) & re.IGNORECASE:
        return None
    runs = []  # (literal, starts_at_0)
    cur = []
    at0 = True
    start0 = True
    for op, av in tree:
        opname = str(op)
        lit = None
        if opname == "LITERAL":
            lit = chr(av)
        elif opname in ("MAX_REPEAT", "MIN_REPEAT"):
            lo, hi, sub = av
            if lo == hi and lo <= 16 and len(sub) == 1 and \
                    str(sub[0][0]) == "LITERAL":
                lit = chr(sub[0][1]) * lo
        if lit is not None:
            if not cur:
                start0 = at0
            cur.append(lit)
        else:
            if cur:
                runs.append(("".join(cur), start0))
                cur = []
            if opname == "AT":  # anchors don't consume
                continue
            at0 = False
    if cur:
        runs.append(("".join(cur), start0))
    if not runs:
        return None
    best = max(runs, key=lambda r: len(r[0]))
    if len(best[0]) < 2:
        return None
    return best


# ---------------------------------------------------------------------------
# device regex engine: host-compiled byte DFA + lockstep steps on the device
# ---------------------------------------------------------------------------

_HOST_BYTES_CACHE: dict = {}   # id(dictionary) -> (ref, (n, L) u8 | None)
_DICT_BYTES_CACHE: dict = {}   # (id(dictionary), device) -> (ref, (L, n) u8 | None)
_PAIRMAT_CACHE: dict = {}      # (id(dictionary), pat, match, device) -> (ref, pairs)
_DFA_CACHE: dict = {}          # (pat, match, device) -> (table, per_state, cmap)
_DEVICE_REGEX_MIN = 8192       # below this the host engines win
_MAX_STRLEN = 63               # +1 sentinel column = 64
_MAX_PAIR_TABLE = 1 << 20      # int32 entries of the two-step table


def _dict_host_bytes(d: np.ndarray) -> Optional[np.ndarray]:
    """(n, maxlen + 1) u8 host byte matrix with one sentinel column; None
    if a value is not ASCII or longer than _MAX_STRLEN. Read from the str
    array's UCS-4 code units, which equal the ASCII bytes (what the
    reference's ``np.char.encode(d, "ascii")`` gives). Cached per
    dictionary."""
    key = id(d)
    hit = _HOST_BYTES_CACHE.get(key)
    if hit is not None and hit[0] is d:
        return hit[1]
    n, w = len(d), d.dtype.itemsize // 4
    units = np.ascontiguousarray(d).view(np.uint32).reshape(n, w)
    used = np.flatnonzero(units.any(axis=0)) if n else np.array([], np.int64)
    maxlen = int(used[-1]) + 1 if len(used) else 0
    out = None
    if maxlen <= _MAX_STRLEN and not (n and units[:, :maxlen].max(initial=0) > 127):
        out = np.zeros((n, maxlen + 1), np.uint8)
        out[:, :maxlen] = units[:, :maxlen]
    if len(_HOST_BYTES_CACHE) > 16:
        _HOST_BYTES_CACHE.clear()
    _HOST_BYTES_CACHE[key] = (d, out)
    return out


def _dict_device_bytes(d: np.ndarray, device) -> Optional[torch.Tensor]:
    """Device (L, n) u8 matrix of the dictionary (transposed for the
    lockstep steps: row t holds every value's byte t), L from the longest
    value plus the sentinel column. Cached per dictionary and device."""
    key = (id(d), str(device))
    hit = _DICT_BYTES_CACHE.get(key)
    if hit is not None and hit[0] is d:
        return hit[1]
    host = _dict_host_bytes(d)
    out = None
    if host is not None:
        out = torch.from_numpy(host).to(device).t().contiguous()
    if len(_DICT_BYTES_CACHE) > 16:
        _DICT_BYTES_CACHE.clear()
    _DICT_BYTES_CACHE[key] = (d, out)
    return out


def _dfa_steps(table: torch.Tensor, rows: torch.Tensor, per_state: int) -> torch.Tensor:
    """Lockstep DFA evaluation: every value starts in state 2 and takes one
    step a row of ``rows`` (its byte, or its byte-class pair), each step a
    gather ``table[state * per_state + symbol]``; a value matches when it
    ends in the sticky ACCEPT state 1. The GPU shape of
    cpp/src/strings/regex/ (one warp per string there): all values in
    lockstep, one gather a step."""
    _dfa_steps.launches += 1
    state = torch.full((rows.shape[1],), 2, dtype=torch.int32, device=rows.device)
    for row in rows:
        state = table.index_select(0, state * per_state + row)
    return state == 1


_dfa_steps.launches = 0


@lru_cache(maxsize=64)
def _compiled_dfa(pat: str, match: bool):
    """(tab, cmap, C, next2) or None: the host DFA, its byte classes and,
    when small enough, its two-step table over class pairs."""
    from .regex_dfa import byte_classes, compile_dfa, pair_steps

    tab = compile_dfa(pat, anchored=match)
    if tab is None:
        return None
    cmap, C = byte_classes(tab)
    next2 = None
    if tab.shape[0] * C * C <= _MAX_PAIR_TABLE:
        next2 = pair_steps(tab, cmap, C)
    return tab, cmap, C, next2


def _device_regex(d: np.ndarray, pat: str, match: bool, device) -> Optional[torch.Tensor]:
    """Device-DFA match flags over the dictionary, or None (fallback)."""
    if len(d) < _DEVICE_REGEX_MIN:
        return None
    ent = _compiled_dfa(pat, bool(match))
    if ent is None:
        return None
    mat = _dict_device_bytes(d, device)
    if mat is None:
        return None
    tab, cmap, C, next2 = ent
    key = (pat, bool(match), str(device))
    dev = _DFA_CACHE.get(key)
    if dev is None:
        if next2 is not None:
            dev = (torch.from_numpy(next2).to(device), C * C,
                   torch.from_numpy(cmap.astype(np.int32)).to(device))
        else:
            dev = (torch.from_numpy(tab.astype(np.int32).reshape(-1)).to(device), 256, None)
        if len(_DFA_CACHE) > 64:
            _DFA_CACHE.clear()
        _DFA_CACHE[key] = dev
    table, per_state, cmap_dev = dev
    if cmap_dev is None:  # one byte a step
        return _dfa_steps(table, mat, per_state)
    return _dfa_steps(table, _pair_rows(d, mat, pat, bool(match), cmap_dev, C), per_state)


def _pair_rows(d: np.ndarray, mat: torch.Tensor, pat: str, match: bool,
               cmap_dev: torch.Tensor, C: int) -> torch.Tensor:
    """(ceil(L / 2), n) int32 class pairs ``c1 * C + c2`` of the dictionary
    for one pattern's byte classes, the symbols of the two-step table.
    Cached per (dictionary, pattern, device), as the reference caches its
    pair matrix: a warm call is only the gather steps."""
    key = (id(d), pat, match, str(mat.device))
    hit = _PAIRMAT_CACHE.get(key)
    if hit is not None and hit[0] is d:
        return hit[1]
    cls = cmap_dev.index_select(0, mat.reshape(-1).to(torch.int32)).reshape(mat.shape)
    if cls.shape[0] % 2:  # one more sentinel column: ACCEPT and DEAD stay
        cls = torch.cat([cls, cls.new_zeros((1, cls.shape[1]))])
    rows = cls[0::2] * C + cls[1::2]
    if len(_PAIRMAT_CACHE) > 8:
        _PAIRMAT_CACHE.clear()
    _PAIRMAT_CACHE[key] = (d, rows)
    return rows


def _dict_predicate_batch_regex(col: Column, pat: str, match: bool) -> Column:
    """Batch regex over the dictionary: the device DFA first, then a
    mandatory-literal prefilter (pyarrow's SIMD substring scan rejects most
    values, the real regex runs on the survivors), then one pyarrow (RE2)
    pass, then Python ``re``."""
    d = _dict_values(col)
    if not len(d):
        return _dict_flags(col, np.zeros((0,), bool))
    dev = _device_regex(d, pat, match, col.device)
    if dev is not None:
        return Column(dtypes.bool_, _table_gather(dev, col.data), col.validity,
                      col.length)
    rpat = "^(?:" + pat + ")" if match else pat
    hint = _mandatory_literal(pat)
    try:
        import pyarrow.compute as pc

        arr = _dict_arrow(d)
        if hint is not None:
            lit, anchored = hint
            if match and anchored:
                cand = pc.starts_with(arr, lit).to_numpy(zero_copy_only=False)
            else:
                cand = pc.match_substring(arr, lit).to_numpy(zero_copy_only=False)
            idx = np.flatnonzero(cand.astype(bool))
            flags = np.zeros(len(d), bool)
            if len(idx):
                if len(idx) < (len(d) >> 2):
                    import re

                    rx = re.compile(rpat)
                    sub = d[idx]
                    hits = np.fromiter((rx.search(x) is not None for x in sub),
                                       bool, len(sub))
                else:  # weak filter: one batch RE2 pass on the survivors
                    hits = pc.match_substring_regex(
                        pa_array(d[idx]), rpat).to_numpy(zero_copy_only=False).astype(bool)
                flags[idx] = hits
        else:
            flags = pc.match_substring_regex(arr, rpat).to_numpy(
                zero_copy_only=False).astype(bool)
    except Exception:  # no pyarrow, or a pattern RE2 rejects: Python re
        import re

        rx = re.compile(pat)
        probe = rx.match if match else rx.search
        flags = np.fromiter((probe(x) is not None for x in d), bool, len(d))
    return _dict_flags(col, flags)


def pa_array(d: np.ndarray):
    import pyarrow as pa

    return pa.array(np.asarray(d, dtype=object), type=pa.string())


def contains(col: Column, pat: str, regex: bool = True) -> Column:
    if regex:
        return _dict_predicate_batch_regex(col, pat, match=False)
    return _dict_predicate_vec(col, lambda d: np.char.find(d, pat) >= 0)


def startswith(col: Column, pat: str) -> Column:
    return _dict_predicate_vec(col, lambda d: np.char.startswith(d, pat))


def endswith(col: Column, pat: str) -> Column:
    return _dict_predicate_vec(col, lambda d: np.char.endswith(d, pat))


def match_like(col: Column, pattern: str) -> Column:
    """SQL LIKE (%, _), used by TPC-H queries (cpp/src/strings/search/like.cu)."""
    import re

    rx = re.compile(
        "^" + "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            for ch in pattern
        ) + "$",
        re.S,
    )
    return _dict_predicate(col, lambda s: rx.match(s) is not None)


def _dict_ints(col: Column, vals: np.ndarray) -> Column:
    """int32 column of per-dictionary-value integers, gathered by code."""
    out = _table_gather(_host_table(vals.astype(np.int32), col), col.data)
    return Column(dtypes.int32, out, col.validity, col.length)


def len_strings(col: Column) -> Column:
    d = _dict_values(col)
    return _dict_ints(col, np.char.str_len(d) if len(d) else np.array([], np.int32))


def concat_strings(cols: List[Column], sep: str = "") -> Column:
    """Row-wise concatenation (host materialization)."""
    vals = [c.to_numpy() for c in cols]
    out = np.array(
        [None if any(v[i] is None for v in vals) else sep.join(str(v[i]) for v in vals)
         for i in range(len(vals[0]))],
        dtype=object,
    )
    return Column.from_numpy(out, device=cols[0].device)


# ===========================================================================
# Strings long tail (cpp/src/strings/: pad, split, replace, find, convert,
# char_types, translate, wrap, repeat); value-level work over the dictionary
# ===========================================================================

def pad(col: Column, width: int, side: str = "left", fillchar: str = " ") -> Column:
    fn = {"left": lambda s: s.rjust(width, fillchar),
          "right": lambda s: s.ljust(width, fillchar),
          "both": lambda s: s.center(width, fillchar)}[side]
    return _dict_map(col, fn)


def zfill(col: Column, width: int) -> Column:
    return _dict_map_vec(col, lambda d: np.char.zfill(d, width))


def repeat_strings(col: Column, repeats: int) -> Column:
    return _dict_map_vec(col, lambda d: np.char.multiply(d, repeats))


def translate(col: Column, table: dict) -> Column:
    tr = str.maketrans(dict(table))
    return _dict_map(col, lambda s: s.translate(tr))


def wrap(col: Column, width: int) -> Column:
    import textwrap

    return _dict_map(col, lambda s: "\n".join(textwrap.wrap(s, width)) if s else s)


def title(col: Column) -> Column:
    return _dict_map_vec(col, np.char.title)


def swapcase(col: Column) -> Column:
    return _dict_map_vec(col, np.char.swapcase)


def replace_str(col: Column, pat: str, repl: str, regex: bool = False,
                n: int = -1) -> Column:
    if regex:
        import re

        rx = re.compile(pat)
        return _dict_map(col, lambda s: rx.sub(repl, s, 0 if n < 0 else n))
    return _dict_map_vec(col, lambda d: np.char.replace(d, pat, repl, n if n >= 0 else -1))


def find(col: Column, sub: str) -> Column:
    d = _dict_values(col)
    return _dict_ints(col, np.char.find(d, sub) if len(d) else np.array([], np.int32))


def rfind(col: Column, sub: str) -> Column:
    d = _dict_values(col)
    return _dict_ints(col, np.char.rfind(d, sub) if len(d) else np.array([], np.int32))


def count_re(col: Column, pat: str) -> Column:
    import re

    rx = re.compile(pat)
    return _dict_ints(col, np.array([len(rx.findall(s)) for s in _dict_values(col)],
                                    np.int32))


def _remap_with_nulls(col: Column, values: np.ndarray, matched: np.ndarray) -> Column:
    """String column from per-dictionary-value strings, null where
    ``matched`` is False: unique over the dictionary's results (not the
    rows), codes remapped by one device gather, ``matched`` gathered as
    validity."""
    filled = np.where(matched, np.asarray(values, dtype=object), "")
    if len(filled) == 0:
        filled, matched = np.array([""], object), np.array([False])
    uniq, inv = np.unique(filled.astype(str), return_inverse=True)
    return _remap_extracted(col, uniq, _host_table(inv.reshape(-1).astype(np.int32), col),
                            _host_table(matched, col))


def _remap_extracted(col: Column, uniq: np.ndarray, inv: torch.Tensor,
                     matched: torch.Tensor) -> Column:
    codes = _table_gather(inv, col.data)
    ok = _table_gather(matched, col.data)
    validity = ok if col.validity is None else (ok & col.validity)
    return Column(dtypes.string, codes, validity, col.length, dictionary=uniq)


def _classrun_plan(pat: str):
    """Parse ``prefix (CLASS-repeat) suffix`` capture shapes the device
    extractor handles; None otherwise. Shapes:
      * unanchored, no prefix/suffix, min-repeat <= 1:  (\\d+)  ([a-z]*)
      * ^-anchored: ``^lit([class]{m,n})lit2$`` with a non-backtracking
        suffix (first suffix byte outside the class; unbounded repeat when
        a suffix exists).
    Reference: cpp/src/strings/extract/extract.cu (general NFA captures;
    this is the vector-friendly subset, host re covers the rest)."""
    import re

    try:
        parser = getattr(re, "_parser", None) or __import__("sre_parse")
        tree = parser.parse(pat)
    except Exception:
        return None
    if getattr(getattr(tree, "state", None), "flags", 0) & (
            re.IGNORECASE | re.MULTILINE | re.DOTALL):
        return None
    from .regex_dfa import _CATEGORIES, _class_bytes, _Unsupported

    items = list(tree)
    anchored = False
    if items and str(items[0][0]) == "AT" and \
            str(items[0][1]) in ("AT_BEGINNING", "AT_BEGINNING_STRING"):
        anchored = True
        items = items[1:]
    end_anchor = False
    if items and str(items[-1][0]) == "AT" and \
            str(items[-1][1]) in ("AT_END", "AT_END_STRING"):
        end_anchor = True
        items = items[:-1]

    def lit_bytes(seq):
        out = []
        for op, av in seq:
            if str(op) != "LITERAL" or av > 127:
                return None
            out.append(av)
        return out

    sub_idx = [i for i, (op, _) in enumerate(items) if str(op) == "SUBPATTERN"]
    if len(sub_idx) != 1:
        return None
    i = sub_idx[0]
    prefix = lit_bytes(items[:i])
    suffix = lit_bytes(items[i + 1:])
    if prefix is None or suffix is None:
        return None
    gid, addf, delf, content = items[i][1]
    if gid != 1 or addf or delf or len(content) != 1:
        return None
    op, av = content[0]
    if str(op) != "MAX_REPEAT":
        return None
    lo, hi, rep = av
    if len(rep) != 1:
        return None
    rop, rav = rep[0]
    try:
        if str(rop) == "IN":
            cls = _class_bytes(rav)
        elif str(rop) == "CATEGORY":
            cls = _CATEGORIES.get(str(rav))
            if cls is None:
                return None
        elif str(rop) == "LITERAL" and rav <= 127:
            cls = frozenset({rav})
        else:
            return None
    except _Unsupported:
        return None
    cls = cls - {0}
    unbounded = hi == getattr(parser, "MAXREPEAT", re.RegexFlag(0)) or hi >= (1 << 16)
    if not anchored:
        if prefix or suffix or end_anchor or lo > 1:
            return None
    if suffix and (suffix[0] in cls or not unbounded):
        return None  # would need backtracking
    return dict(anchored=anchored, prefix=prefix, cls=cls, lo=lo,
                hi=None if unbounded else hi, suffix=suffix,
                end_anchor=end_anchor)


def _classrun_kernel(mat: torch.Tensor, lut: torch.Tensor, prefix: List[int],
                     suffix: List[int], lo: int, hi: Optional[int], maxret: int,
                     end_anchor: bool, anchored: bool):
    """Single-capture extraction over the (L, n) byte matrix, all values in
    lockstep: start position, greedy class-run length, suffix and end
    checks, extracted bytes (cpp/src/strings/extract/extract.cu is one warp
    per string). Returns (bytes (maxret, n) u8, run length, matched)."""
    _classrun_kernel.launches += 1
    L, n = mat.shape
    dev = mat.device
    C = lut.index_select(0, mat.reshape(-1).to(torch.int32)).reshape(L, n)  # 1 = class byte
    if anchored:
        start = torch.full((n,), len(prefix), dtype=torch.int64, device=dev)
        ok = torch.ones((n,), dtype=torch.bool, device=dev)
        for t, b in enumerate(prefix):
            ok = ok & (mat[t] == b)
    else:
        start = torch.argmax(C, dim=0)  # the first class byte
        ok = C.amax(dim=0) > 0
    pos = start[None, :] + torch.arange(L, device=dev)[:, None]
    inb = pos < L
    posc = pos.clamp(max=L - 1)
    shifted = torch.gather(C, 0, posc) * inb
    bshift = torch.gather(mat, 0, posc) * inb
    allones = shifted.amin(dim=0) > 0
    r = torch.where(allones, L, torch.argmin(shifted, dim=0))  # the first non-class byte
    if hi is not None:
        r = r.clamp(max=hi)
    ok = ok & (r >= lo)
    end_off = r
    for t, b in enumerate(suffix):
        bt = torch.gather(bshift, 0, (r + t).clamp(max=L - 1)[None, :])[0]
        ok = ok & (bt == b) & (r + t < L)
        end_off = r + len(suffix)
    if end_anchor:
        bt = torch.gather(bshift, 0, end_off.clamp(max=L - 1)[None, :])[0]
        ok = ok & ((bt == 0) | (end_off >= L))
    tcol = torch.arange(maxret, device=dev)[:, None]
    outb = torch.where(tcol < r[None, :], bshift[:maxret], 0).to(torch.uint8)
    return outb, r, ok


_classrun_kernel.launches = 0


def _unique_rows(outb: torch.Tensor, keep: torch.Tensor):
    """Sorted distinct strings of an (m, n) u8 byte matrix (one value a
    column, NUL-padded ASCII; a column where ``keep`` is False counts as
    ""), and each column's code into them, on the device: the bytes packed
    big-endian into int64 words (ASCII keeps them positive, so integer
    order is string order), sorted word by word with stable sorts, new
    values marked where a word changes. What ``np.unique`` over the values
    gives, without a host sort of every value."""
    m, n = outb.shape
    W = max((m + 7) // 8, 1)
    b = torch.zeros((W * 8, n), dtype=torch.int64, device=outb.device)
    b[:m] = outb.to(torch.int64)
    b = b * keep.to(torch.int64)[None, :]
    shifts = torch.arange(56, -8, -8, device=outb.device)
    words = (b.reshape(W, 8, n) << shifts[None, :, None]).sum(dim=1)  # (W, n)
    perm = torch.arange(n, device=outb.device)
    for w in range(W - 1, -1, -1):
        perm = perm[torch.sort(words[w, perm], stable=True).indices]
    sw = words[:, perm]
    new = torch.ones(n, dtype=torch.bool, device=outb.device)
    if n > 1:
        new[1:] = (sw[:, 1:] != sw[:, :-1]).any(dim=0)
    gid = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    inv = torch.empty(n, dtype=torch.int32, device=outb.device)
    inv[perm] = gid
    uw = sw[:, new].cpu().numpy()  # (W, u)
    ub = ((uw[:, None, :] >> np.arange(56, -8, -8)[None, :, None]) & 0xFF).astype(np.uint32)
    u = uw.shape[1]
    uniq = np.ascontiguousarray(ub.reshape(W * 8, u).T).view(f"<U{W * 8}").reshape(u)
    return uniq, inv


def _device_extract(col: Column, d: np.ndarray, pat: str) -> Optional[Column]:
    """Device class-run capture extraction, or None (host fallback)."""
    if len(d) < _DEVICE_REGEX_MIN:
        return None
    plan = _classrun_plan(pat)
    if plan is None:
        return None
    mat = _dict_device_bytes(d, col.device)
    if mat is None:
        return None
    L = int(mat.shape[0])
    lut = np.zeros((256,), np.int32)
    lut[list(plan["cls"])] = 1
    maxret = min(plan["hi"] or L, L)
    outb, _, ok = _classrun_kernel(
        mat, torch.from_numpy(lut).to(col.device), plan["prefix"], plan["suffix"],
        int(plan["lo"]), plan["hi"], int(maxret), bool(plan["end_anchor"]),
        bool(plan["anchored"]))
    uniq, inv = _unique_rows(outb, ok)
    return _remap_extracted(col, uniq, inv, ok)


def extract_re(col: Column, pat: str, group: int = 1) -> Column:
    """First regex capture group per row; null on no match (extract.cu).

    Device class-run lane for ``prefix(CLASS+)suffix`` shapes; host ``re``
    over the dictionary otherwise. Both assemble the output through a code
    remap and one device gather, never a per-row loop."""
    d = _dict_values(col)
    if group == 1 and len(d):
        dev = _device_extract(col, d, pat)
        if dev is not None:
            return dev
    import re

    rx = re.compile(pat)
    vals = []
    for s in d:
        m = rx.search(s)
        vals.append(m.group(group) if m and m.lastindex and m.lastindex >= group
                    else None)
    matched = np.array([v is not None for v in vals], bool)
    return _remap_with_nulls(col, np.array(vals, dtype=object), matched)


def split_expand(col: Column, delimiter: str = " ", maxsplit: int = -1) -> Table:
    """split into a Table of string columns (strings::split, expand=True)."""
    d = _dict_values(col)
    parts = [s.split(delimiter, maxsplit) if maxsplit >= 0 else s.split(delimiter)
             for s in d]
    width = max((len(p) for p in parts), default=0)
    n = col.length
    codes = col.data[:n].cpu().numpy()
    v = None if col.validity is None else col.validity[:n].cpu().numpy()
    cols = {}
    for j in range(width):
        vals = []
        for i in range(n):
            if v is not None and not v[i]:
                vals.append(None)
            else:
                p = parts[codes[i]] if 0 <= codes[i] < len(parts) else []
                vals.append(p[j] if j < len(p) else None)
        validity = np.array([x is not None for x in vals])
        cols[str(j)] = Column.from_numpy(np.array(vals, object), validity,
                                         device=col.device)
    return Table(cols)


def split_record(col: Column, delimiter: str = " ", maxsplit: int = -1):
    """split into a list column of tokens per row (strings::split_record)."""
    raise NotImplementedError("split_record returns a list column, which is not "
                              "ported yet (ROADMAP queue 1 item 14, core/lists.py)")


def partition_strings(col: Column, delimiter: str = " ") -> Table:
    """3-column table: (head, sep, tail) (strings::partition)."""
    heads = _dict_map(col, lambda s: s.partition(delimiter)[0])
    seps = _dict_map(col, lambda s: s.partition(delimiter)[1])
    tails = _dict_map(col, lambda s: s.partition(delimiter)[2])
    return Table({"head": heads, "sep": seps, "tail": tails})


# ------------------------------------------------------ char-type predicates
def isalpha(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.isalpha())


def isdigit(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.isdigit())


def isalnum(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.isalnum())


def isspace(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.isspace())


def isupper(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.isupper())


def islower(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.islower())


def isdecimal(col: Column) -> Column:
    return _dict_predicate(col, lambda s: bool(s) and s.isdecimal())


# ----------------------------------------------------------- conversions
def _dict_numeric(col: Column, fn, np_dtype, default) -> Column:
    """Per-value parse; a value that does not parse is null."""
    d = _dict_values(col)
    vals = np.empty(len(d), np_dtype)
    ok = np.zeros(len(d), bool)
    for i, s in enumerate(d):
        try:
            vals[i] = fn(s)
            ok[i] = True
        except (ValueError, OverflowError):
            vals[i] = default
    out = _table_gather(_host_table(vals, col), col.data)
    okg = _table_gather(_host_table(ok, col), col.data)
    validity = okg if col.validity is None else (okg & col.validity)
    return Column(dtypes.from_numpy(np.dtype(np_dtype)), out, validity, col.length)


def to_integers(col: Column) -> Column:
    """strings::to_integers; unparseable -> null."""
    return _dict_numeric(col, lambda s: int(s, 10), np.int64, 0)


def to_floats(col: Column) -> Column:
    return _dict_numeric(col, float, np.float64, 0.0)


def _from_host_values(col: Column, out: list) -> Column:
    """String column of host values (None is null) on ``col``'s device."""
    arr = np.array(out, object)
    validity = np.array([v is not None for v in out], bool)
    return Column.from_numpy(np.where(validity, arr, None),
                             validity if not validity.all() else None,
                             device=col.device)


def from_integers(col: Column) -> Column:
    """int column -> decimal string column (strings::from_integers)."""
    return _from_host_values(col, [None if v is None else str(int(v))
                                   for v in col.to_numpy()])


def from_floats(col: Column) -> Column:
    return _from_host_values(col, [
        None if v is None or (isinstance(v, float) and np.isnan(v)) else repr(float(v))
        for v in col.to_numpy()])


def ipv4_to_integers(col: Column) -> Column:
    def conv(s):
        a, b, c, d = s.split(".")
        return (int(a) << 24) | (int(b) << 16) | (int(c) << 8) | int(d)

    return _dict_numeric(col, conv, np.int64, 0)


def integers_to_ipv4(col: Column) -> Column:
    def fmt(v):
        v = int(v)
        return f"{(v >> 24) & 255}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"

    return _from_host_values(col, [None if v is None else fmt(v)
                                   for v in col.to_numpy()])


def hex_to_integers(col: Column) -> Column:
    return _dict_numeric(col, lambda s: int(s, 16), np.int64, 0)


def integers_to_hex(col: Column) -> Column:
    return _from_host_values(col, [None if v is None else format(int(v), "X")
                                   for v in col.to_numpy()])


def to_booleans(col: Column, true_string: str = "true") -> Column:
    return _dict_predicate(col, lambda s: s == true_string)


def url_encode(col: Column) -> Column:
    from urllib.parse import quote

    return _dict_map(col, lambda s: quote(s, safe=""))


def url_decode(col: Column) -> Column:
    from urllib.parse import unquote

    return _dict_map(col, unquote)
