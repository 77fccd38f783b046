"""Device bloom filter for join and shuffle pre-filtering (counterpart of
``cudf_tpu/ops/bloom.py``).

Analog of cpp/libcudf_streaming/src/detail/device_bloom_filter.cu, which
the streaming engine uses to drop probe rows whose keys cannot be on the
build side before shuffling them. The filter is a bool[m] tensor, one byte
a bit (a scatter of True needs no atomics); the k probe positions come
from double hashing, ``h1 + i * h2`` mod 2^32 mod m, over two murmur3 row
hashes (seeds 0 and 0x9E3779B9, the second forced odd), so a build is k
scatters and a probe k gathers.

A key hashes by value, whatever table it comes from: a string as a 64-bit
hash of its value (pandas' ``hash_array``, two words), not its dictionary
code, and a null as the value 0 with no null-flag word. For a numeric key
without a mask the bits are the reference's. Faults of the reference not
copied (each pinned by a test): it hashes a string's dictionary code, so a
probe column on another dictionary than the build's gets false negatives;
and it hashes a masked column's null-flag word, so a key probed from a
column with a mask misses the same key built from a column without one.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from . import hashing

_SEED2 = 0x9E3779B9
_MASK = 0xFFFFFFFF


class BloomFilter(NamedTuple):
    bits: torch.Tensor   # bool[m]
    k: int               # probes a key


def _key_words(cols: Sequence[Column]) -> List[torch.Tensor]:
    """The u32 words a key hashes: a string's value hash (two words), any
    other column's value words (``hashing``); a null reads as 0."""
    from ..utils.real_pandas import pd

    words: List[torch.Tensor] = []
    for c in cols:
        if c.dtype.is_string:
            values = c.dictionary if c.dictionary is not None else np.array([], str)
            h = pd.util.hash_array(np.asarray(values, dtype=object)).view(np.int64)
            table = torch.from_numpy(np.append(h, 0)).to(c.device)
            v = table[c.data.to(torch.int64).clamp(0, len(values))]
            ws = [(v >> 32) & _MASK, v & _MASK]
        else:
            ws = hashing._value_words(c)
        if c.validity is not None:
            ws = [torch.where(c.validity, w, 0) for w in ws]
        words.extend(ws)
    return words


def _positions(cols: Sequence[Column], m: int, k: int) -> List[torch.Tensor]:
    words = _key_words(cols)
    h1 = hashing.hash_operands(words, 0)
    h2 = hashing.hash_operands(words, _SEED2) | 1
    return [((h1 + i * h2) & _MASK) % m for i in range(k)]


def build(cols: Sequence[Column], m_log2: int = 20, k: int = 3) -> BloomFilter:
    """A filter of 2^m_log2 bits over the rows of the key columns."""
    m = 1 << m_log2
    dev = cols[0].device
    inb = cols[0].bounds_mask()
    bits = torch.zeros(m + 1, dtype=torch.bool, device=dev)  # slot m: the padding sink
    for p in _positions(cols, m, k):
        bits[torch.where(inb, p, m)] = True
    return BloomFilter(bits[:m], k)


def maybe_contains(bf: BloomFilter, cols: Sequence[Column]) -> Column:
    """bool per probe row: possibly present (no false negatives)."""
    out = torch.ones(cols[0].capacity, dtype=torch.bool, device=cols[0].device)
    for p in _positions(cols, bf.bits.shape[0], bf.k):
        out &= bf.bits[p]
    return Column(dtypes.bool_, out, None, cols[0].length)


def merge(filters: Sequence[BloomFilter]) -> BloomFilter:
    """Distributed combine: OR of the bit arrays."""
    bits = filters[0].bits
    for f in filters[1:]:
        bits = bits | f.bits
    return BloomFilter(bits, filters[0].k)
