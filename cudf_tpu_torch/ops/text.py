"""Text utilities, an nvtext subset (counterpart of ``cudf_tpu/ops/text.py``):
tokenize, n-grams, minhash, jaccard, edit distance, normalization, token
replacement and filtering, BPE.

Analog of cpp/src/text/. Dictionary encoding makes the host the place for
value-level text work: each distinct string is processed once, and the
results come back to the rows through the codes. ``count_tokens`` counts on
the device over the dictionary's byte matrix (``strings._dict_device_bytes``).
Functions whose result is a list column (``wordpiece_tokenize``) raise until
list columns are ported (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column, _pad_to
from ..core.table import Table
from ..utils.padding import bucket_capacity
from .strings import (_dict_device_bytes, _dict_map, _dict_values, _host_table,
                      _table_gather)


def _unique_token_lists(col: Column, delimiter: str):
    """(flat_tokens, offsets, counts) of each distinct value's tokens, split
    with pandas' string engine over the dictionary, never over the rows."""
    from ..utils.real_pandas import pd

    d = _dict_values(col).astype(object)
    if len(d) == 0:
        return np.array([], object), np.zeros(1, np.int64), np.zeros(0, np.int64)
    lists = pd.Series(d).str.split(delimiter)
    counts = lists.str.len().fillna(0).to_numpy(np.int64)
    flat = np.concatenate([np.asarray(x, object) for x in lists.to_list()]) \
        if counts.sum() else np.array([], object)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return flat, offsets, counts


def _explode_by_code(col: Column, flat: np.ndarray, offsets: np.ndarray,
                     counts: np.ndarray) -> Column:
    """Per-row explode of per-value item lists (repeat + cumulative
    positions in numpy), emitted dictionary-encoded: the exploded strings
    themselves are never built."""
    n = col.length
    codes = col.data[:n].cpu().numpy().astype(np.int64)
    if col.validity is not None:
        codes = np.where(col.validity[:n].cpu().numpy(), codes, -1)
    codes_ok = codes[(codes >= 0) & (codes < len(counts))]
    reps = counts[codes_ok]
    uni_rep = np.repeat(codes_ok, reps)
    starts = np.repeat(offsets[codes_ok], reps)
    within = np.arange(len(uni_rep)) - np.repeat(np.cumsum(reps) - reps, reps)
    if not len(uni_rep):
        return Column.from_numpy(np.array([], object), device=col.device)
    uniq, inv = np.unique(flat.astype(str), return_inverse=True)
    out_codes = inv.reshape(-1)[starts + within].astype(np.int32)
    n_out = len(out_codes)
    return Column(dtypes.string, _pad_to(out_codes, bucket_capacity(n_out), col.device),
                  None, n_out, dictionary=uniq)


def tokenize(col: Column, delimiter: str = " ") -> Column:
    """Explode each string into tokens (nvtext::tokenize)."""
    return _explode_by_code(col, *_unique_token_lists(col, delimiter))


def _count_tokens_device(mat: torch.Tensor, delim: int) -> torch.Tensor:
    """Per-value token counts over the dictionary's (L, n) byte matrix: one
    compare and a sum down each column (len(s.split(d)) == count(d in s) +
    1; "" has 0 tokens, as in nvtext). The nvtext::count_tokens analog
    (cpp/src/text/tokenize.cu) with the dictionary's bytes on the device."""
    _count_tokens_device.launches += 1
    hits = (mat == delim).sum(dim=0, dtype=torch.int32)
    return torch.where(mat[0] != 0, hits + 1, 0).to(torch.int32)


_count_tokens_device.launches = 0


def count_tokens(col: Column, delimiter: str = " ") -> Column:
    d = _dict_values(col)
    if len(delimiter) == 1 and ord(delimiter) < 128 and len(d) >= 1024:
        mat = _dict_device_bytes(d, col.device)
        if mat is not None:
            table = _count_tokens_device(mat, ord(delimiter))
            return Column(dtypes.int32, _table_gather(table, col.data),
                          col.validity, col.length)
    counts = np.array([len(s.split(delimiter)) if s else 0 for s in d], dtype=np.int32)
    return Column(dtypes.int32, _table_gather(_host_table(counts, col), col.data),
                  col.validity, col.length)


def generate_ngrams(col: Column, n: int = 2, sep: str = "_") -> Column:
    """nvtext::generate_ngrams over the value sequence (across rows), from
    n shifted value arrays with numpy's string concat."""
    vals = col.to_numpy()
    vals = np.asarray([v for v in vals if v is not None], dtype=object)
    m = len(vals) - n + 1
    if m <= 0:
        return Column.from_numpy(np.array([], object), device=col.device)
    acc = vals[:m].astype(str)
    for k in range(1, n):
        acc = np.char.add(np.char.add(acc, sep), vals[k:k + m].astype(str))
    return Column.from_numpy(acc.astype(object), device=col.device)


def _unique_char_ngrams(col: Column, n: int):
    """Each distinct value's character n-grams, by sliding windows over a
    fixed-width byte buffer of the dictionary (ASCII), or by per-position
    pandas slicing (non-ASCII, where byte windows would split code
    points)."""
    d = _dict_values(col).astype(object)
    if len(d) == 0:
        return np.array([], object), np.zeros(1, np.int64), np.zeros(0, np.int64)
    try:
        b = np.asarray(d, dtype=str).astype(bytes)  # ASCII check + encode
        ascii_ok = True
    except UnicodeEncodeError:
        ascii_ok = False
    if ascii_ok:
        lens = np.char.str_len(b).astype(np.int64)
        counts = np.maximum(lens - n + 1, 0)
        maxlen = int(lens.max()) if len(lens) else 0
        if maxlen < n:
            return (np.array([], object), np.concatenate([[0], np.cumsum(counts)]),
                    counts)
        wid = b.dtype.itemsize
        u8 = b.view(np.uint8).reshape(len(b), wid)
        win = np.lib.stride_tricks.sliding_window_view(u8, n, axis=1)
        mask = np.arange(win.shape[1])[None, :] < counts[:, None]
        grams = np.ascontiguousarray(win[mask])            # (total, n) u8
        flat = grams.view(f"S{n}").ravel().astype(str).astype(object)
    else:
        from ..utils.real_pandas import pd

        ser = pd.Series(d).astype(str)
        lens = ser.str.len().to_numpy(np.int64)
        counts = np.maximum(lens - n + 1, 0)
        maxpos = int(counts.max()) if len(counts) else 0
        cols = [ser.str.slice(i, i + n).to_numpy() for i in range(maxpos)]
        if maxpos:
            mat = np.stack(cols, axis=1)
            mask = np.arange(maxpos)[None, :] < counts[:, None]
            flat = np.asarray(mat[mask], object)
        else:
            flat = np.array([], object)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return flat, offsets, counts


def character_ngrams(col: Column, n: int = 2) -> Column:
    return _explode_by_code(col, *_unique_char_ngrams(col, n))


def _char_shingles(s: str, width: int) -> set:
    return {s[i: i + width] for i in range(max(len(s) - width + 1, 1))}


def minhash(col: Column, seeds=(0, 1, 2, 3), width: int = 4) -> Table:
    """nvtext::minhash: per row, the min of its shingles' hashes per seed
    (pandas' object-array hasher with a per-seed key, over the dictionary)."""
    from pandas.util import hash_array

    from ..utils.real_pandas import pd

    d = _dict_values(col)
    nd = max(len(d), 1)
    ser = pd.Series(np.asarray(d, object) if len(d) else np.array([], object)).astype(str)
    lens = ser.str.len().to_numpy(np.int64) if len(d) else np.zeros(0, np.int64)
    counts = np.maximum(lens - width + 1, 1) if len(d) else np.zeros(0, np.int64)
    maxpos = int(counts.max()) if len(counts) else 0
    grams_cols = [ser.str.slice(i, i + width).to_numpy() for i in range(maxpos)]
    out = {}
    for seed in seeds:
        hv = np.full(nd, 0, np.uint32)
        if maxpos:
            best = np.full(len(d), 0xFFFFFFFF, np.uint64)
            for i, g in enumerate(grams_cols):
                live = counts > i
                h = hash_array(np.asarray(g, object), hash_key=f"{seed:016d}") \
                    & np.uint64(0xFFFFFFFF)
                best = np.where(live, np.minimum(best, h), best)
            hv = best.astype(np.uint32)
        # gathered as int64 (torch has no uint32 index_select), stored as u32
        table = _host_table(hv.astype(np.int64), col)
        out[f"minhash_{seed}"] = Column(
            dtypes.uint32, _table_gather(table, col.data).to(torch.uint32), col.validity,
            col.length)
    return Table(out)


def jaccard_index(a: Column, b: Column, width: int = 4) -> Column:
    """nvtext::jaccard_index between paired rows."""
    av, bv = a.to_numpy(), b.to_numpy()
    out = np.zeros(len(av), np.float32)
    for i, (x, y) in enumerate(zip(av, bv)):
        if x is None or y is None:
            out[i] = np.nan
            continue
        sx, sy = _char_shingles(str(x), width), _char_shingles(str(y), width)
        union = len(sx | sy)
        out[i] = len(sx & sy) / union if union else 0.0
    return Column.from_numpy(out, device=a.device)


def edit_distance(a: Column, b: Column) -> Column:
    """nvtext::edit_distance (Levenshtein) between paired rows."""
    av, bv = a.to_numpy(), b.to_numpy()
    out = np.zeros(len(av), np.int32)
    for i, (x, y) in enumerate(zip(av, bv)):
        x = "" if x is None else str(x)
        y = "" if y is None else str(y)
        m, n = len(x), len(y)
        prev = list(range(n + 1))
        for r in range(1, m + 1):
            cur = [r] + [0] * n
            for c in range(1, n + 1):
                cur[c] = min(prev[c] + 1, cur[c - 1] + 1,
                             prev[c - 1] + (x[r - 1] != y[c - 1]))
            prev = cur
        out[i] = prev[n]
    return Column.from_numpy(out, device=a.device)


def normalize_spaces(col: Column) -> Column:
    return _dict_map(col, lambda s: " ".join(s.split()))


def porter_stem(col: Column) -> Column:
    """Minimal porter-style suffix stripping (step-1a subset)."""
    def stem(s: str) -> str:
        for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
            if s.endswith(suf):
                return s[: len(s) - len(suf)] + rep
        return s

    return _dict_map(col, stem)


# ===========================================================================
# Subword tokenizers (nvtext wordpiece_tokenize / byte_pair_encode): one
# tokenization per distinct value, on the host
# ===========================================================================

class WordPieceVocabulary:
    """Greedy longest-match-first subword vocab (BERT-style '##' pieces)."""

    def __init__(self, tokens, unk: str = "[UNK]"):
        self.index = {t: i for i, t in enumerate(tokens)}
        self.unk_id = self.index.get(unk, 0)
        self.max_piece = max((len(t) for t in tokens), default=1)

    def encode_word(self, word: str):
        ids = []
        i = 0
        while i < len(word):
            end = min(len(word), i + self.max_piece)
            found = None
            while end > i:
                piece = word[i:end] if i == 0 else "##" + word[i:end]
                if piece in self.index:
                    found = self.index[piece]
                    break
                end -= 1
            if found is None:
                return [self.unk_id]
            ids.append(found)
            i = end
        return ids


def wordpiece_tokenize(col: Column, vocab: WordPieceVocabulary,
                       max_tokens_per_row: int = 64):
    """Token ids per row as a list column (nvtext::wordpiece_tokenize)."""
    raise NotImplementedError("wordpiece_tokenize returns a list column, which is "
                              "not ported yet (ROADMAP queue 1 item 14, core/lists.py)")


class BPEMergePairs:
    """Ranked merge table (load_merge_pairs analog)."""

    def __init__(self, pairs):
        self.rank = {tuple(p.split() if isinstance(p, str) else p): i
                     for i, p in enumerate(pairs)}


def _bpe_word(word: str, rank) -> List[str]:
    parts = list(word)
    while len(parts) > 1:
        best, best_rank = None, None
        for i in range(len(parts) - 1):
            r = rank.get((parts[i], parts[i + 1]))
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best is None:
            break
        parts[best: best + 2] = [parts[best] + parts[best + 1]]
    return parts


def byte_pair_encode(col: Column, merges: BPEMergePairs, separator: str = " ") -> Column:
    """BPE-split each string (nvtext::byte_pair_encoding): pieces joined by
    ``separator``, spaces between input words kept."""
    cache = {}

    def encode(s: str) -> str:
        words = []
        for w in s.split(" "):
            if w not in cache:
                cache[w] = separator.join(_bpe_word(w, merges.rank))
            words.append(cache[w])
        return " ".join(words)

    return _dict_map(col, encode)


def replace_tokens(col: Column, targets, replacements, delimiter: str = " ") -> Column:
    """nvtext::replace_tokens: whole-token substitution."""
    if isinstance(replacements, str):
        replacements = [replacements] * len(targets)
    table = dict(zip(targets, replacements))
    return _dict_map(col, lambda s: delimiter.join(table.get(t, t)
                                                   for t in s.split(delimiter)))


def filter_tokens(col: Column, min_token_length: int, replacement: str = "",
                  delimiter: str = " ") -> Column:
    """nvtext::filter_tokens: drop or replace tokens shorter than a minimum."""
    def fn(s):
        out = [(t if len(t) >= min_token_length else replacement)
               for t in s.split(delimiter)]
        return delimiter.join(x for x in out if x != "") if replacement == "" \
            else delimiter.join(out)

    return _dict_map(col, fn)


def normalize_characters(col: Column, do_lower: bool = True) -> Column:
    """nvtext::normalize_characters: NFKD, accents and control characters
    dropped, whitespace unified, optionally lowercased."""
    import unicodedata

    def fn(s):
        s = unicodedata.normalize("NFKD", s)
        s = "".join(c for c in s if not unicodedata.combining(c)
                    and (unicodedata.category(c)[0] != "C" or c in "\t\n\r"))
        s = " ".join(s.split())
        return s.lower() if do_lower else s

    return _dict_map(col, fn)


def ngrams_tokenize(col: Column, n: int = 2, delimiter: str = " ",
                    sep: str = "_") -> Column:
    """nvtext::ngrams_tokenize: each row's token n-grams (explode
    semantics), built per distinct value from shifted slices of its token
    list, then exploded through the codes."""
    flat, offsets, counts = _unique_token_lists(col, delimiter)
    g_counts = np.maximum(counts - n + 1, 0)
    total = int(g_counts.sum())
    if total == 0:
        return Column.from_numpy(np.array([], object), device=col.device)
    uni = np.repeat(np.arange(len(counts)), g_counts)
    within = np.arange(total) - np.repeat(np.cumsum(g_counts) - g_counts, g_counts)
    starts = offsets[uni] + within
    acc = flat[starts].astype(str)
    for k in range(1, n):
        acc = np.char.add(np.char.add(acc, sep), flat[starts + k].astype(str))
    g_offsets = np.concatenate([[0], np.cumsum(g_counts)])
    return _explode_by_code(col, np.asarray(acc, object), g_offsets, g_counts)


def deduplicate(col: Column, min_width: int = 5) -> Column:
    """nvtext::deduplicate: per row, collapse repeated substrings of at
    least ``min_width`` characters (a greedy scan over the dictionary)."""
    def dedup_one(s: str) -> str:
        out = []
        i = 0
        while i < len(s):
            w = len(s) - i
            dropped = False
            while w >= min_width:
                if s.startswith(s[i:i + w], i + w):
                    out.append(s[i:i + w])
                    i += 2 * w
                    dropped = True
                    break
                w -= 1
            if not dropped:
                out.append(s[i])
                i += 1
        return "".join(out)

    return _dict_map(col, dedup_one)
