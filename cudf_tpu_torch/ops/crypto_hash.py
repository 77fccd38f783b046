"""Cryptographic and non-cryptographic row hashers on the device
(counterpart of ``cudf_tpu/ops/crypto_hash.py``).

Analog of cpp/src/hash/ (md5_hash.cu, sha_hash.cuh, xxhash_32.cu,
xxhash_64.cu). The reference launches one thread per row and walks its
bytes; here, as in the reference port, every register of the hash state is
a tensor over the rows and the compression rounds are unrolled elementwise
ops, so all rows step through the rounds together.

The row message:

* md5/sha*: the concatenated little-endian physical bytes of each non-null
  value of the row, in column order (a null contributes no bytes). A float
  is normalized first, as cuDF's hashers do: every NaN is the quiet NaN
  and -0.0 is +0.0. A string contributes its UTF-8 bytes, gathered by code
  from a byte matrix of the dictionary. Digests are bit-exact against
  ``hashlib`` over those bytes; rows of different lengths are padded and
  stop updating once their own blocks are done.
* xxhash_32/64: the row's u32 equality words (``hashing.equality_words``,
  the reference's ``rowcodes.equality_operands``) as a little-endian
  stream, so hash equality follows row equality (null == null,
  NaN == NaN, -0 == +0), as murmur3's does.

Arithmetic: torch has no unsigned 32- or 64-bit ops on the CPU, so 32-bit
words live in int64 tensors, masked to 32 bits after each add, multiply
and shift; 64-bit words are int64 tensors whose adds and multiplies wrap
mod 2^64, with the logical right shift written as an arithmetic shift and
a mask. A digest column is a string column: the digests are deduplicated
and sorted on the device (a stable sort by their big-endian words, whose
order is the hex strings' order, and adjacent compares) and spelled in hex
there, as the code points of a numpy str array, which one copy brings to
the host.

Faults of the reference not copied: its f64 bytes flush subnormals to
zero (a TPU limit), and its f32 bytes keep -0.0 and the NaN payload, so an
f32 -0.0 digests apart from +0.0 while its f64 -0.0 does not; and its
xxhash, like its murmur3, hashes an f32 -0.0 apart from +0.0.
"""
from __future__ import annotations

from decimal import Decimal, getcontext
from typing import List, Sequence

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.dtypes import Kind
from ..utils.padding import bucket_capacity
from .hashing import _mul32, equality_words
from .rowcodes import adjacent_neq
from .sortprim import multisort_perm

M32 = 0xFFFFFFFF
DIGESTS = ("md5", "sha1", "sha224", "sha256", "sha384", "sha512")


def _s64(c: int) -> int:
    """A 64-bit constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


# =========================================================================
# Row messages
# =========================================================================

def _float_bits(col: Column) -> torch.Tensor:
    """A float column's IEEE bits (int64), NaN made quiet and -0 made +0."""
    x = col.data
    if col.dtype.bits == 64:
        x = torch.where(x == 0, torch.zeros_like(x), x)
        bits = x.view(torch.int64)
        return torch.where(torch.isnan(x), _s64(0x7FF8000000000000), bits)
    x = x.to(torch.float32)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    bits = x.view(torch.int32).to(torch.int64) & M32
    return torch.where(torch.isnan(x), 0x7FC00000, bits)


def _value_bytes(col: Column):
    """(bytes uint8[cap, w], keep bool[cap, w]) of one column."""
    cap = col.capacity
    dev = col.device
    if col.dtype.is_string:
        d = col.dictionary if col.dictionary is not None else np.array([], str)
        enc = [s.encode("utf-8") for s in np.asarray(d, dtype=str).tolist()]
        width = max([1] + [len(b) for b in enc])
        mat = np.zeros((max(len(enc), 1), width), np.uint8)
        lens = np.zeros(max(len(enc), 1), np.int64)
        for i, b in enumerate(enc):
            mat[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
        codes = col.data.to(torch.int64).clamp(0, mat.shape[0] - 1)
        byts = torch.from_numpy(mat).to(dev)[codes]
        keep = (torch.arange(width, device=dev)[None, :]
                < torch.from_numpy(lens).to(dev)[codes][:, None])
    else:
        w = max(col.dtype.bits // 8, 1)
        if col.dtype.kind == Kind.FLOAT:
            w = 8 if col.dtype.bits == 64 else 4
            bits = _float_bits(col)
        elif col.dtype.kind == Kind.BOOL:
            bits = col.data.to(torch.int64)
        elif col.dtype.kind == Kind.UINT and col.dtype.bits == 64:
            bits = col.data.view(torch.int64)
        else:
            bits = col.data.to(torch.int64)
        shifts = torch.arange(0, 8 * w, 8, device=dev)
        byts = ((bits[:, None] >> shifts[None, :]) & 0xFF).to(torch.uint8)
        keep = torch.ones((cap, w), dtype=torch.bool, device=dev)
    return byts, keep & col.valid_mask()[:, None]


def _row_messages(cols: Sequence[Column]):
    """(bytes uint8[cap, W], message length int64[cap]): each row's kept
    bytes moved to its front in order (a stable sort of the drop flags)."""
    parts = [_value_bytes(c) for c in cols]
    B = torch.cat([b for b, _ in parts], dim=1)
    K = torch.cat([k for _, k in parts], dim=1)
    order = torch.sort((~K).to(torch.int8), dim=1, stable=True).indices
    return torch.gather(B, 1, order), K.sum(dim=1)


def _padded_blocks(Bc, msg_len, block_bytes: int, len_bytes: int, len_be: bool):
    """Merkle-Damgard padding: the message, 0x80, zeros and the bit length;
    (buffer uint8[cap, nb * block_bytes], blocks per row, nb)."""
    cap, W = Bc.shape
    nb = (W + 1 + len_bytes + block_bytes - 1) // block_bytes
    total = nb * block_bytes
    dev = Bc.device
    pos = torch.arange(total, device=dev)[None, :]
    ml = msg_len[:, None]
    nb_row = (msg_len + 1 + len_bytes + block_bytes - 1) // block_bytes
    src = torch.zeros((cap, total), dtype=torch.int64, device=dev)
    src[:, :W] = Bc.to(torch.int64)
    out = torch.where(pos < ml, src, 0)
    out = torch.where(pos == ml, 0x80, out)
    j_rel = pos - (nb_row[:, None] * block_bytes - len_bytes)
    in_len = (j_rel >= 0) & (j_rel < len_bytes)
    shift = (len_bytes - 1 - j_rel) if len_be else j_rel
    bitlen = ml * 8
    lb = torch.where(shift < 8, (bitlen >> (shift.clamp(0, 7) * 8)) & 0xFF, 0)
    out = torch.where(in_len, lb, out)
    return out, nb_row, nb


def _words32(buf, nb: int, block_bytes: int, big_endian: bool) -> torch.Tensor:
    """int64[nb, words, cap] of 32-bit words."""
    cap = buf.shape[0]
    b = buf.reshape(cap, nb, block_bytes // 4, 4)
    order = (3, 2, 1, 0) if big_endian else (0, 1, 2, 3)
    w = b[..., order[0]] | (b[..., order[1]] << 8) | (b[..., order[2]] << 16) \
        | (b[..., order[3]] << 24)
    return w.permute(1, 2, 0)


def _words64(buf, nb: int, block_bytes: int) -> torch.Tensor:
    """int64[nb, words, cap] of big-endian 64-bit words."""
    cap = buf.shape[0]
    b = buf.reshape(cap, nb, block_bytes // 8, 8)
    w = torch.zeros(b.shape[:-1], dtype=torch.int64, device=buf.device)
    for j in range(8):
        w = w | (b[..., j] << (8 * (7 - j)))
    return w.permute(1, 2, 0)


# =========================================================================
# MD5 (RFC 1321), SHA-1 and SHA-2 (FIPS 180-4)
# =========================================================================

_MD5_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
_MD5_K = [int(abs(np.sin(i + 1)) * 2**32) & M32 for i in range(64)]
_MD5_G = ([i for i in range(16)] + [(5 * i + 1) % 16 for i in range(16, 32)]
          + [(3 * i + 5) % 16 for i in range(32, 48)] + [(7 * i) % 16 for i in range(48, 64)])
_MD5_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)
_SHA1_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_SHA256_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C,
              0x1F83D9AB, 0x5BE0CD19)
_SHA224_IV = (0xC1059ED8, 0x367CD507, 0x3070DD17, 0xF70E5939, 0xFFC00B31, 0x68581511,
              0x64F98FA7, 0xBEFA4FA4)
_SHA512_IV = (0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
              0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179)
_SHA384_IV = (0xCBBB9D5DC1059ED8, 0x629A292A367CD507, 0x9159015A3070DD17, 0x152FECD8F70E5939,
              0x67332667FFC00B31, 0x8EB44A8768581511, 0xDB0C2E0D64F98FA7, 0x47B5481DBEFA4FA4)


def _sha512_k() -> List[int]:
    """SHA-512's round constants: the first 64 bits of the fractional parts
    of the cube roots of the first 80 primes."""
    primes: List[int] = []
    p = 2
    while len(primes) < 80:
        if all(p % q for q in primes):
            primes.append(p)
        p += 1
    getcontext().prec = 50
    out = []
    for q in primes:
        c = Decimal(q) ** (Decimal(1) / Decimal(3))
        out.append(int((c - int(c)) * (1 << 64)) & ((1 << 64) - 1))
    return out


_SHA512_K = _sha512_k()


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _rotr32(x, r: int):
    return ((x >> r) | (x << (32 - r))) & M32


def _not32(x):
    return ~x & M32


def _lsr64(x, r: int):
    """Logical right shift of 64-bit words held in int64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotr64(x, r: int):
    return _lsr64(x, r) | (x << (64 - r))


def _md5_compress(state, M):
    a, b, c, d = state
    for i in range(64):
        ph = i // 16
        if ph == 0:
            f = (b & c) | (_not32(b) & d)
        elif ph == 1:
            f = (d & b) | (_not32(d) & c)
        elif ph == 2:
            f = b ^ c ^ d
        else:
            f = c ^ (b | _not32(d))
        t = (f + a + _MD5_K[i] + M[_MD5_G[i]]) & M32
        a, b, c, d = d, (b + _rotl32(t, _MD5_S[i])) & M32, b, c
    return tuple((s + v) & M32 for s, v in zip(state, (a, b, c, d)))


def _schedule(M, rounds: int, ext):
    W = list(M)
    for t in range(16, rounds):
        W.append(ext(W, t))
    return W


def _sha1_compress(state, M):
    W = _schedule(M, 80, lambda W, t: _rotl32(W[t - 3] ^ W[t - 8] ^ W[t - 14] ^ W[t - 16], 1))
    a, b, c, d, e = state
    for t in range(80):
        ph = t // 20
        if ph == 0:
            f, k = (b & c) | (_not32(b) & d), 0x5A827999
        elif ph == 1:
            f, k = b ^ c ^ d, 0x6ED9EBA1
        elif ph == 2:
            f, k = (b & c) | (b & d) | (c & d), 0x8F1BBCDC
        else:
            f, k = b ^ c ^ d, 0xCA62C1D6
        tmp = (_rotl32(a, 5) + f + e + k + W[t]) & M32
        a, b, c, d, e = tmp, a, _rotl32(b, 30), c, d
    return tuple((s + v) & M32 for s, v in zip(state, (a, b, c, d, e)))


def _sha256_ext(W, t):
    s0 = _rotr32(W[t - 15], 7) ^ _rotr32(W[t - 15], 18) ^ (W[t - 15] >> 3)
    s1 = _rotr32(W[t - 2], 17) ^ _rotr32(W[t - 2], 19) ^ (W[t - 2] >> 10)
    return (W[t - 16] + s0 + W[t - 7] + s1) & M32


def _sha256_compress(state, M):
    W = _schedule(M, 64, _sha256_ext)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
        ch = (e & f) ^ (_not32(e) & g)
        t1 = (h + S1 + ch + _SHA256_K[t] + W[t]) & M32
        S0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
        t2 = (S0 + ((a & b) ^ (a & c) ^ (b & c))) & M32
        a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
    return tuple((s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h)))


def _sha512_ext(W, t):
    s0 = _rotr64(W[t - 15], 1) ^ _rotr64(W[t - 15], 8) ^ _lsr64(W[t - 15], 7)
    s1 = _rotr64(W[t - 2], 19) ^ _rotr64(W[t - 2], 61) ^ _lsr64(W[t - 2], 6)
    return W[t - 16] + s0 + W[t - 7] + s1


def _sha512_compress(state, M):
    W = _schedule(M, 80, _sha512_ext)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        S1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + _s64(_SHA512_K[t]) + W[t]
        S0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
        t2 = S0 + ((a & b) ^ (a & c) ^ (b & c))
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return tuple(s + v for s, v in zip(state, (a, b, c, d, e, f, g, h)))


# name: (iv, compress, block bytes, length bytes, words big-endian, word bits,
#        output words)
_ALGOS = {
    "md5": (_MD5_IV, _md5_compress, 64, 8, False, 32, 4),
    "sha1": (_SHA1_IV, _sha1_compress, 64, 8, True, 32, 5),
    "sha224": (_SHA224_IV, _sha256_compress, 64, 8, True, 32, 7),
    "sha256": (_SHA256_IV, _sha256_compress, 64, 8, True, 32, 8),
    "sha384": (_SHA384_IV, _sha512_compress, 128, 16, True, 64, 6),
    "sha512": (_SHA512_IV, _sha512_compress, 128, 16, True, 64, 8),
}


def _digest_state(cols: Sequence[Column], algo: str):
    iv, compress, bb, lb, big_endian, wordbits, _ = _ALGOS[algo]
    Bc, msg_len = _row_messages(cols)
    buf, nb_row, nb = _padded_blocks(Bc, msg_len, bb, lb, big_endian)
    cap = buf.shape[0]
    dev = buf.device
    if wordbits == 32:
        words = _words32(buf, nb, bb, big_endian)
        state = tuple(torch.full((cap,), v, dtype=torch.int64, device=dev) for v in iv)
    else:
        words = _words64(buf, nb, bb)
        state = tuple(torch.full((cap,), _s64(v), dtype=torch.int64, device=dev) for v in iv)
    for blk in range(nb):
        new = compress(state, [words[blk, j] for j in range(words.shape[1])])
        active = blk < nb_row
        state = tuple(torch.where(active, n, s) for n, s in zip(new, state))
    return state


def _bswap32(x):
    return ((x & 0xFF) << 24) | (((x >> 8) & 0xFF) << 16) | (((x >> 16) & 0xFF) << 8) \
        | ((x >> 24) & 0xFF)


def hexdigest(cols: Sequence[Column], algo: str) -> Column:
    """Per-row hex digest (cudf.hashing md5/sha*) as a string column."""
    if algo not in _ALGOS:
        raise ValueError(f"unknown digest {algo!r}")
    _, _, _, _, big_endian, wordbits, out_words = _ALGOS[algo]
    state = _digest_state(cols, algo)[:out_words]
    n = cols[0].length
    if wordbits == 64:  # each 64-bit word as its two big-endian halves
        be = [h for w in state for h in ((w >> 32) & M32, w & M32)]
    else:
        be = [w if big_endian else _bswap32(w) for w in state]
    if n == 0:
        return Column(dtypes.string, torch.zeros(bucket_capacity(0), dtype=torch.int32,
                                                 device=be[0].device),
                      None, 0, dictionary=np.array([], dtype=str))
    be = [w[:n] for w in be]
    perm = multisort_perm(be)
    first = adjacent_neq([w[perm] for w in be])
    inv = torch.empty(n, dtype=torch.int64, device=perm.device)
    inv[perm] = torch.cumsum(first.to(torch.int64), 0) - 1
    uniq = torch.stack([w[perm[first]] for w in be], dim=1)
    # spelled in hex on the device, as the UTF-32 code points of numpy's str
    nib = (uniq[:, :, None] >> torch.arange(28, -1, -4, device=uniq.device)) & 0xF
    chars = torch.where(nib < 10, nib + ord("0"), nib + ord("a") - 10).to(torch.int32)
    width = 8 * uniq.shape[1]
    dictionary = chars.reshape(-1, width).cpu().numpy().view(f"<U{width}").reshape(-1)
    codes = torch.zeros(bucket_capacity(n), dtype=torch.int32, device=perm.device)
    codes[:n] = inv.to(torch.int32)
    return Column(dtypes.string, codes, None, n, dictionary=dictionary)


def md5(cols: Sequence[Column]) -> Column:
    """Per-row MD5 hex digest (cudf.hashing md5 analog)."""
    return hexdigest(cols, "md5")


def sha1(cols: Sequence[Column]) -> Column:
    return hexdigest(cols, "sha1")


def sha224(cols: Sequence[Column]) -> Column:
    return hexdigest(cols, "sha224")


def sha256(cols: Sequence[Column]) -> Column:
    return hexdigest(cols, "sha256")


def sha384(cols: Sequence[Column]) -> Column:
    return hexdigest(cols, "sha384")


def sha512(cols: Sequence[Column]) -> Column:
    return hexdigest(cols, "sha512")


# =========================================================================
# XXH32 / XXH64 over the equality words
# =========================================================================

_X32P = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_X64P = tuple(_s64(p) for p in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                                0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                                0x27D4EB2F165667C5))


def _operand_words(cols: Sequence[Column]) -> List[torch.Tensor]:
    ws: List[torch.Tensor] = []
    for c in cols:
        ws.extend(equality_words(c))
    return ws


def _xxh32(ws: List[torch.Tensor], seed: int) -> torch.Tensor:
    P1, P2, P3, P4, P5 = _X32P
    total = 4 * len(ws)
    seed &= M32
    i = 0
    if total >= 16:
        v = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed, (seed - P1) & M32]
        v = [torch.full_like(ws[0], x) for x in v]
        while total - 4 * i >= 16:
            for lane in range(4):
                v[lane] = _mul32(_rotl32((v[lane] + _mul32(ws[i + lane], P2)) & M32, 13), P1)
            i += 4
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12)
             + _rotl32(v[3], 18)) & M32
    else:
        h = torch.full_like(ws[0], (seed + P5) & M32)
    h = (h + total) & M32
    while i < len(ws):
        h = _mul32(_rotl32((h + _mul32(ws[i], P3)) & M32, 17), P4)
        i += 1
    h = _mul32(h ^ (h >> 15), P2)
    h = _mul32(h ^ (h >> 13), P3)
    return h ^ (h >> 16)


def _rotl64(x, r: int):
    return (x << r) | _lsr64(x, 64 - r)


def _xxh64(ws: List[torch.Tensor], seed: int) -> torch.Tensor:
    P1, P2, P3, P4, P5 = _X64P
    w64 = [ws[k] | (ws[k + 1] << 32) for k in range(0, len(ws) - 1, 2)]
    tail = ws[-1] if len(ws) % 2 else None
    total = 4 * len(ws)
    seed = _s64(seed & ((1 << 64) - 1))

    def rnd(acc, x):
        return _rotl64(acc + x * P2, 31) * P1

    i = 0
    if total >= 32:
        v = [torch.full_like(ws[0], _s64((seed + P1 + P2) % (1 << 64))),
             torch.full_like(ws[0], _s64((seed + P2) % (1 << 64))),
             torch.full_like(ws[0], seed),
             torch.full_like(ws[0], _s64((seed - P1) % (1 << 64)))]
        while total - 8 * i >= 32:
            for lane in range(4):
                v[lane] = rnd(v[lane], w64[i + lane])
            i += 4
        h = _rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + _rotl64(v[3], 18)
        for lane in range(4):
            h = (h ^ rnd(torch.zeros_like(h), v[lane])) * P1 + P4
    else:
        h = torch.full_like(ws[0], _s64((seed + P5) % (1 << 64)))
    h = h + total
    while i < len(w64):
        h = _rotl64(h ^ rnd(torch.zeros_like(h), w64[i]), 27) * P1 + P4
        i += 1
    if tail is not None:
        h = _rotl64(h ^ (tail * P1), 23) * P2 + P3
    h = (h ^ _lsr64(h, 33)) * P2
    h = (h ^ _lsr64(h, 29)) * P3
    return h ^ _lsr64(h, 32)


def xxhash_32(cols: Sequence[Column], seed: int = 0) -> Column:
    """Per-row XXH32 (pylibcudf.hashing.xxhash_32 analog), uint32."""
    out = _xxh32(_operand_words(cols), int(seed)).to(torch.int32).view(torch.uint32)
    return Column(dtypes.uint32, out, None, cols[0].length)


def xxhash_64(cols: Sequence[Column], seed: int = 0) -> Column:
    """Per-row XXH64 (pylibcudf.hashing.xxhash_64 analog), uint64."""
    out = _xxh64(_operand_words(cols), int(seed)).view(torch.uint64)
    return Column(dtypes.uint64, out, None, cols[0].length)
