"""The port's hash table against cudf_tpu's (``kernels/hashtable.py``).

Same numpy u32 key words, made from a seed, go to both packages: the
reference's ``build_table`` (XLA scatter rounds) and ``probe_table``
(Pallas, interpret mode on the CPU), and the port's torch ``build_table``
and ``probe_table`` (on CPU tensors, its plain version). The port holds
words as int32 tensors with the u32 bit pattern. Everything is compared
exactly: hashes, table words, payloads, ``all_placed`` and probe results.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudf_tpu.kernels import hashtable as ref
from cudf_tpu_torch.kernels import hashtable as port


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy words -> the port's int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _keys(rng, n, dup=False):  # tests/test_kernels.py:9-13
    base = rng.choice(2**31, size=n, replace=dup)
    return (base & 0xFFFF).astype(np.uint32), (base >> 16).astype(np.uint32)


def test_mix_matches_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)
    h1 = np.concatenate([np.repeat(edge, len(edge)),
                         rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)])
    h2 = np.concatenate([np.tile(edge, len(edge)),
                         rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(ref._mix(jnp.asarray(h1), jnp.asarray(h2))).astype(np.int64)
    got = port._mix(_t(h1), _t(h2))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 8, 9, 5000, 10**6])
def test_table_size_for_matches_reference(n):
    assert port.table_size_for(n) == ref.table_size_for(n)


def _build_case(name):
    """(k1, k2, valid, m) as numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "test_kernels_distinct":  # tests/test_kernels.py:16-33
        n = 5000
        k1, k2 = _keys(rng, n)
        return k1, k2, np.ones(n, bool), ref.table_size_for(n)
    if name == "test_kernels_invalid_rows":  # tests/test_kernels.py:36-43
        return (np.array([1, 2, 3], np.uint32), np.zeros(3, np.uint32),
                np.array([True, False, True]), 16)
    if name == "duplicate_keys":  # each key ~4 times: the smallest row id wins
        k1, k2 = _keys(rng, 1000)
        pick = rng.integers(0, 1000, 4000)
        return k1[pick], k2[pick], np.ones(4000, bool), 4 * ref.table_size_for(1000)
    if name == "unplaced_long_chain":  # 61% load: a chain outgrows MAX_PROBE
        k1, k2 = _keys(rng, 20_000)
        return k1, k2, np.ones(20_000, bool), 32_768
    if name == "invalid_rows":
        n = 3000
        k1, k2 = _keys(rng, n)
        return k1, k2, rng.random(n) < 0.7, ref.table_size_for(n)
    if name == "too_full":  # 300 keys in 256 slots: some row finds no slot
        k1, k2 = _keys(rng, 300)
        return k1, k2, np.ones(300, bool), 256
    if name == "m16":
        k1, k2 = _keys(rng, 6)
        return k1, k2, np.ones(6, bool), 16
    raise KeyError(name)


BUILD_CASES = ["test_kernels_distinct", "test_kernels_invalid_rows", "duplicate_keys",
               "invalid_rows", "too_full", "m16", "unplaced_long_chain"]
UNPLACED = {"too_full", "unplaced_long_chain"}


@pytest.mark.parametrize("name", BUILD_CASES)
def test_build_table_matches_reference(name):
    k1, k2, valid, m = _build_case(name)
    r = ref.build_table(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(valid), m)
    p = port.build_table(_t(k1), _t(k2), torch.from_numpy(valid), m)
    np.testing.assert_array_equal(_u32(p[0]), np.asarray(r[0]))
    np.testing.assert_array_equal(_u32(p[1]), np.asarray(r[1]))
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(r[2]))
    assert p[3] == bool(r[3])
    assert p[3] == (name not in UNPLACED)
    if name == "duplicate_keys":  # every key's payload is its first row
        first = {}
        for i, (a, b) in enumerate(zip(k1, k2)):
            first.setdefault((int(a), int(b)), i)
        occ = p[2].numpy() != port.EMPTY
        got = {(int(a), int(b)): int(c) for a, b, c in
               zip(_u32(p[0])[occ], _u32(p[1])[occ], p[2].numpy()[occ])}
        assert got == first


@pytest.mark.parametrize("name", BUILD_CASES)
def test_build_table_returns_columns_of_one_slot_tensor(name):
    """tk1, tk2 and payload are columns 0-2 of one 16 B-aligned
    int32[m+1, 4] tensor whose column 3 is 0: the probe kernel's layout."""
    k1, k2, valid, m = _build_case(name)
    p = port.build_table(_t(k1), _t(k2), torch.from_numpy(valid), m)
    base = p[0]._base
    assert base is not None and base.shape == (m + 1, 4) and base.dtype == torch.int32
    assert base.data_ptr() % 16 == 0
    for i in range(3):
        assert p[i].shape == (m,) and p[i].stride() == (4,)
        assert p[i].data_ptr() == base.data_ptr() + 4 * i
    assert not base[:, 3].any()
    assert torch.equal(port.slot_tensor(*p[:3]), base[:m])


def _chain(kind):
    """A hand-built table of m = 64 slots and one query (q1, q2) whose
    probe chain is laid out by ``kind``. Returns (tables, q1, q2, want)."""
    m = 64
    q1, q2 = np.uint32(0xDEADBEEF), np.uint32(12345)
    if kind == "wraps_past_last_slot":  # a query whose home is slot m - 3
        cand = np.arange(12345, 12345 + 4096, dtype=np.uint32)
        hs = np.asarray(ref._mix(jnp.full(len(cand), q1), jnp.asarray(cand)))
        q2 = cand[np.flatnonzero((hs & (m - 1)) == m - 3)[0]]
    h = int(np.asarray(ref._mix(jnp.asarray([q1]), jnp.asarray([q2])))[0])
    tk1 = np.zeros(m, np.uint32)
    tk2 = np.zeros(m, np.uint32)
    pay = np.full(m, port.EMPTY, np.int32)

    def put(i, a, b, row):
        s = (h + i) & (m - 1)
        tk1[s], tk2[s], pay[s] = a, b, row

    if kind == "match_at_probe_15":
        for i in range(15):
            put(i, q1, np.uint32(i + 1), 100 + i)  # same k1, other k2
        put(15, q1, q2, 7)
        want = 7
    elif kind == "absent_after_16_occupied":
        for i in range(16):
            put(i, np.uint32(i), q2, 100 + i)  # other k1, same k2
        put(16, q1, q2, 7)  # past MAX_PROBE
        want = port.EMPTY
    elif kind == "vacant_before_match":
        for i in range(3):
            put(i, np.uint32(i), np.uint32(i), 100 + i)
        put(4, q1, q2, 7)  # slot 3 vacant: the search stops there
        want = port.EMPTY
    elif kind == "wraps_past_last_slot":
        for i in range(5):  # slots m-3 .. m-1, 0, 1
            put(i, q1, np.uint32(i + 1), 100 + i)
        put(5, q1, q2, 7)   # slot 2
        want = 7
    else:
        raise KeyError(kind)
    return (tk1, tk2, pay), q1, q2, want


CHAINS = ["match_at_probe_15", "absent_after_16_occupied", "vacant_before_match",
          "wraps_past_last_slot"]


@pytest.mark.parametrize("kind", CHAINS)
def test_probe_chain_edges_match_reference(kind):
    (tk1, tk2, pay), q1, q2, want = _chain(kind)
    # the query, plus every key stored in the table, plus an absent key
    occ = pay != port.EMPTY
    Q1 = np.concatenate([[q1], tk1[occ], [np.uint32(99)]]).astype(np.uint32)
    Q2 = np.concatenate([[q2], tk2[occ], [np.uint32(98)]]).astype(np.uint32)
    r = np.asarray(ref.probe_table(jnp.asarray(tk1), jnp.asarray(tk2), jnp.asarray(pay),
                                   jnp.asarray(Q1), jnp.asarray(Q2)))
    p = port.probe_table(_t(tk1), _t(tk2), torch.from_numpy(pay), _t(Q1), _t(Q2))
    np.testing.assert_array_equal(p.numpy(), r)
    assert p[0].item() == want


def _probe_case(name):
    """(k1, k2, valid, m, q1, q2) as numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "present_and_absent":  # tests/test_kernels.py:16-33
        k1, k2, valid, m = _build_case("test_kernels_distinct")
        q1 = np.concatenate([k1[:2000], k1[:1000] ^ np.uint32(0xDEAD)])
        q2 = np.concatenate([k2[:2000], k2[:1000]])
        return k1, k2, valid, m, q1, q2
    if name == "invalid_rows":  # tests/test_kernels.py:36-43
        k1, k2, valid, m = _build_case("test_kernels_invalid_rows")
        return k1, k2, valid, m, k1, k2
    if name == "m16":
        k1, k2, valid, m = _build_case("m16")
        q1 = np.concatenate([k1, k1 + np.uint32(1)])
        q2 = np.concatenate([k2, k2])
        return k1, k2, valid, m, q1, q2
    if name == "ragged_n":  # N not a multiple of the reference's 8192 tile
        k1, k2 = _keys(rng, 2000)
        n = 2 * 8192 + 77
        pick = rng.integers(0, 2000, n)
        q1 = np.where(rng.random(n) < 0.8, k1[pick], k1[pick] ^ np.uint32(1))
        return k1, k2, np.ones(2000, bool), 4 * ref.table_size_for(2000), q1, k2[pick]
    if name in ("duplicate_keys", "unplaced_long_chain"):
        k1, k2, valid, m = _build_case(name)
        return k1, k2, valid, m, k1, k2
    raise KeyError(name)


PROBE_CASES = ["present_and_absent", "invalid_rows", "m16", "ragged_n", "duplicate_keys",
               "unplaced_long_chain"]


@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_table_matches_reference(name):
    k1, k2, valid, m, q1, q2 = _probe_case(name)
    rt = ref.build_table(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(valid), m)
    pt = port.build_table(_t(k1), _t(k2), torch.from_numpy(valid), m)
    want = np.asarray(ref.probe_table(*rt[:3], jnp.asarray(q1), jnp.asarray(q2)))
    got = port.probe_table(*pt[:3], _t(q1), _t(q2))
    assert got.dtype == torch.int32 and got.shape == (len(q1),)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's probe on the reference's table
    got_r = port.probe_table(_t(np.asarray(rt[0])), _t(np.asarray(rt[1])),
                             torch.from_numpy(np.asarray(rt[2])), _t(q1), _t(q2))
    np.testing.assert_array_equal(got_r.numpy(), want)
    # and, where every row was placed, against a dict oracle: the smallest
    # valid row id of each key
    assert pt[3] == (name not in UNPLACED)
    if not pt[3]:
        return
    lut = {}
    for i, (a, b) in enumerate(zip(k1, k2)):
        if valid[i]:
            lut.setdefault((int(a), int(b)), i)
    exp = [lut.get((int(a), int(b)), port.EMPTY) for a, b in zip(q1, q2)]
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("name", PROBE_CASES)
@pytest.mark.parametrize("layout", ["slots", "separate"])
def test_probe_table_takes_both_layouts(name, layout):
    """build_table's slot views and three separate contiguous arrays give
    the reference's answer."""
    k1, k2, valid, m, q1, q2 = _probe_case(name)
    rt = ref.build_table(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(valid), m)
    want = np.asarray(ref.probe_table(*rt[:3], jnp.asarray(q1), jnp.asarray(q2)))
    table = port.build_table(_t(k1), _t(k2), torch.from_numpy(valid), m)[:3]
    if layout == "separate":
        table = [x.contiguous() for x in table]
        assert all(x.stride() == (1,) for x in table)
    assert (port._check(*table, _t(q1), _t(q2)) is None) == (layout == "separate")
    np.testing.assert_array_equal(port.probe_table(*table, _t(q1), _t(q2)).numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "rank", "not_pow2", "lengths", "query_lengths",
                                 "devices", "contiguity", "wrong_offsets", "stride_3",
                                 "unaligned_base"])
def test_probe_wrapper_rejects_bad_inputs(bad):
    m, n = 16, 10
    t = [torch.zeros(m, dtype=torch.int32) for _ in range(2)]
    pay = torch.full((m,), port.EMPTY, dtype=torch.int32)
    q = [torch.zeros(n, dtype=torch.int32) for _ in range(2)]
    if bad == "dtype":
        q[0] = q[0].to(torch.int64)
    elif bad == "rank":
        q[0] = q[0][:, None]
    elif bad == "not_pow2":
        t = [torch.zeros(12, dtype=torch.int32) for _ in range(2)]
        pay = torch.full((12,), port.EMPTY, dtype=torch.int32)
    elif bad == "lengths":
        pay = pay[:8]
    elif bad == "query_lengths":
        q[1] = q[1][:5]
    elif bad == "devices":
        q[1] = q[1].to("meta")
    elif bad == "contiguity":
        q[0] = torch.zeros(2 * n, dtype=torch.int32)[::2]
    elif bad == "wrong_offsets":  # slot columns in another order
        slots = torch.zeros((m + 1, 4), dtype=torch.int32)
        t, pay = [slots[:m, 1], slots[:m, 0]], slots[:m, 2]
    elif bad == "stride_3":  # columns of an int32[m, 3] tensor
        slots = torch.zeros((m, 3), dtype=torch.int32)
        t, pay = [slots[:, 0], slots[:, 1]], slots[:, 2]
    elif bad == "unaligned_base":  # stride 4, but the base 4 B past 16 B
        slots = torch.zeros(4 * m + 8, dtype=torch.int32)[1:4 * m + 5].view(m + 1, 4)
        t, pay = [slots[:m, 0], slots[:m, 1]], slots[:m, 2]
    with pytest.raises((TypeError, ValueError)):
        port.probe_table(*t, pay, *q)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises: here a meta
    tensor, for which no kernel exists, must raise."""
    m, n = 16, 10
    args = [torch.zeros(m, dtype=torch.int32, device="meta") for _ in range(3)] + \
           [torch.zeros(n, dtype=torch.int32, device="meta") for _ in range(2)]
    before = port.probe_table.launches
    with pytest.raises(ValueError, match="no kernel"):
        port.probe_table(*args)
    assert port.probe_table.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    k1, k2, valid, m, q1, q2 = _probe_case(name)
    table = [x.cuda() for x in port.build_table(_t(k1).cuda(), _t(k2).cuda(),
                                                torch.from_numpy(valid).cuda(), m)[:3]]
    q = [_t(q1).cuda(), _t(q2).cuda()]
    before = port.probe_table.launches
    got = port.probe_table(*table, *q)
    torch.cuda.synchronize()
    assert port.probe_table.launches == before + 1
    assert torch.equal(got, port.probe_table_plain(*table, *q))


def _slot_views(tk1, tk2, pay, device="cpu"):
    """Hand-built table words as columns 0-2 of a 16 B slot tensor."""
    slots = torch.zeros((len(tk1) + 1, 4), dtype=torch.int32)
    slots[:-1, 0], slots[:-1, 1], slots[:-1, 2] = _t(tk1), _t(tk2), torch.from_numpy(pay)
    slots = slots.to(device)
    return [slots[:-1, i] for i in range(3)]


@pytest.mark.parametrize("kind", CHAINS)
def test_hand_built_chains_in_slot_layout(kind):
    (tk1, tk2, pay), q1, q2, want = _chain(kind)
    table = _slot_views(tk1, tk2, pay)
    assert port.slot_tensor(*table) is not None
    got = port.probe_table(*table, _t([q1, 99]), _t([q2, 98]))
    assert got.tolist() == [want, port.EMPTY]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CHAINS)
@pytest.mark.parametrize("layout", ["slots", "separate"])
def test_probe_kernel_chains_and_layouts_on_card(kind, layout):
    """Hand-built chains, the wrap past slot m-1 among them, in both
    layouts: the slot views reach the kernel as they are, separate arrays
    are packed once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    (tk1, tk2, pay), q1, q2, want = _chain(kind)
    if layout == "slots":
        table = _slot_views(tk1, tk2, pay, "cuda")
    else:
        table = [_t(tk1).cuda(), _t(tk2).cuda(), torch.from_numpy(pay).cuda()]
    q = [_t([q1, 99]).cuda(), _t([q2, 98]).cuda()]
    packs = port.probe_table.packs
    got = port.probe_table(*table, *q)
    torch.cuda.synchronize()
    assert port.probe_table.packs == packs + (layout == "separate")
    assert got.tolist() == [want, port.EMPTY]
    assert torch.equal(got, port.probe_table_plain(*table, *q))


# ------------------------------------------------ insert_table (no probe cap)
def _first_rows(k1, k2, valid) -> dict:
    """The dict oracle: each valid key's smallest row id."""
    lut = {}
    for i, (a, b) in enumerate(zip(k1, k2)):
        if valid[i]:
            lut.setdefault((int(a), int(b)), i)
    return lut


def _contents(table) -> dict:
    tk1, tk2, pay = (x.cpu() for x in table)
    occ = pay.numpy() != port.EMPTY
    return {(int(a), int(b)): int(c) for a, b, c in
            zip(_u32(tk1)[occ], _u32(tk2)[occ], pay.numpy()[occ])}


def _longest(table) -> int:
    """The longest displacement of a stored key from its home slot."""
    tk1, tk2, pay = table
    occ = pay != port.EMPTY
    if not occ.any():
        return 0
    slot = torch.nonzero(occ).squeeze(1)
    return int(((slot - port._mix(tk1[occ], tk2[occ])) & (tk1.shape[0] - 1)).max())


def _queries(k1, k2):
    """Every build key, then each key made absent (k1 < 2^16 in every
    case, so k1 | 2^16 is no key)."""
    return (np.concatenate([k1, k1 | np.uint32(1 << 16)]).astype(np.uint32),
            np.concatenate([k2, k2]).astype(np.uint32))


@pytest.mark.parametrize("name", BUILD_CASES)
def test_insert_plain_places_every_key_with_its_smallest_row(name):
    """The rounds with no cap: each valid key once, with its smallest valid
    row id, the unplaced row of the capped rounds too; ``occupied`` the
    distinct keys, ``longest`` the table's longest displacement; a probe
    that far finds every key. Where the capped rounds place every row the
    table is theirs, word for word."""
    k1, k2, valid, m = _build_case(name)
    args = (_t(k1), _t(k2), torch.from_numpy(valid), m)
    if name == "too_full":  # 300 distinct keys, 256 slots
        with pytest.raises(ValueError, match="no slot"):
            port.insert_table_plain(*args)
        return
    tk1, tk2, pay, occupied, longest = port.insert_table_plain(*args)
    want = _first_rows(k1, k2, valid)
    assert _contents((tk1, tk2, pay)) == want
    assert occupied == len(want)
    assert longest == _longest((tk1, tk2, pay))
    assert (longest >= port.MAX_PROBE) == (name in UNPLACED)
    base = tk1._base
    assert base.shape == (m + 1, 4) and base.data_ptr() % 16 == 0 and not base[:, 3].any()
    assert torch.equal(port.slot_tensor(tk1, tk2, pay), base[:m])
    capped = port.build_table(*args)
    if capped[3]:
        for got, ref_col in zip((tk1, tk2, pay), capped[:3]):
            assert torch.equal(got, ref_col)
    q1, q2 = _queries(k1, k2)
    exp = [want.get((int(a), int(b)), port.EMPTY) for a, b in zip(q1, q2)]
    got = port.probe_table(tk1, tk2, pay, _t(q1), _t(q2), max_probe=longest + 1)
    np.testing.assert_array_equal(got.numpy(), exp)


def _one_home_chain(m=1024, n=48):
    """n keys (k1, 0), k1 small integers found by brute force, whose hash
    lands on one home slot of m."""
    k1 = np.arange(200_000, dtype=np.uint32)
    homes = port._mix(_t(k1), _t(np.zeros_like(k1))).numpy() & (m - 1)
    pick = k1[homes == homes[0]][:n]
    assert len(pick) == n
    return pick, np.zeros(n, np.uint32), m


def test_insert_places_a_chain_past_max_probe_and_the_probe_needs_its_bound():
    """48 keys on one home slot in m = 1024: the insert places them all,
    the j-th row at displacement j; a probe of ``longest + 1`` slots finds
    each, the default 16 only the first 16."""
    k1, k2, m = _one_home_chain()
    n = len(k1)
    launches, past = port.insert_table.launches, port.insert_table.past_max_probe
    tk1, tk2, pay, occupied, longest = port.insert_table(
        _t(k1), _t(k2), torch.ones(n, dtype=torch.bool), m)
    assert port.insert_table.launches == launches  # the CPU runs the plain version
    assert port.insert_table.past_max_probe == past + 1
    assert (occupied, longest) == (n, n - 1)
    rows = np.arange(n, dtype=np.int32)
    found = port.probe_table(tk1, tk2, pay, _t(k1), _t(k2), max_probe=longest + 1)
    np.testing.assert_array_equal(found.numpy(), rows)
    capped = port.probe_table(tk1, tk2, pay, _t(k1), _t(k2))
    np.testing.assert_array_equal(capped.numpy(),
                                  np.where(rows < port.MAX_PROBE, rows, port.EMPTY))
    assert not port.build_table(_t(k1), _t(k2), torch.ones(n, dtype=torch.bool), m)[3]


@pytest.mark.parametrize("probe", ["plain", "wrapper"])
def test_max_probe_17_reaches_past_the_16_occupied(probe):
    (tk1, tk2, pay), q1, q2, _ = _chain("absent_after_16_occupied")
    fn = port.probe_table_plain if probe == "plain" else port.probe_table
    args = (_t(tk1), _t(tk2), torch.from_numpy(pay), _t([q1, 99]), _t([q2, 98]))
    assert fn(*args, max_probe=17).tolist() == [7, port.EMPTY]
    assert fn(*args).tolist() == [port.EMPTY, port.EMPTY]


@pytest.mark.parametrize("bad", ["dtype", "valid_dtype", "lengths", "not_pow2", "too_big",
                                 "devices", "contiguity", "meta", "max_probe"])
def test_insert_and_probe_wrappers_reject_bad_inputs(bad):
    n, m = 10, 16
    k = [torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)]
    valid = torch.ones(n, dtype=torch.bool)
    err = ValueError
    if bad == "dtype":
        k[0], err = k[0].to(torch.int64), TypeError
    elif bad == "valid_dtype":
        valid, err = valid.to(torch.int32), TypeError
    elif bad == "lengths":
        valid = valid[:5]
    elif bad == "not_pow2":
        m = 12
    elif bad == "too_big":
        m = 1 << 31
    elif bad == "devices":
        valid = valid.to("meta")
    elif bad == "contiguity":
        k[1] = torch.zeros(2 * n, dtype=torch.int32)[::2]
    elif bad == "meta":  # no kernel for the device: raises, launches nothing
        k, valid = [x.to("meta") for x in k], valid.to("meta")
    elif bad == "max_probe":
        table = port.insert_table(*k, valid, m)[:3]
        with pytest.raises(ValueError, match="max_probe"):
            port.probe_table(*table, *k, max_probe=0)
        return
    launches = port.insert_table.launches
    with pytest.raises(err):
        port.insert_table(*k, valid, m)
    assert port.insert_table.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", BUILD_CASES)
def test_insert_kernel_matches_plain_on_card(name):
    """The kernel's table holds what the plain version's does (the layout
    may differ: it depends on the schedule): the same probe answers and
    ``occupied``; ``longest`` is the kernel's own table's longest
    displacement. One launch a build."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    k1, k2, valid, m = _build_case(name)
    cpu = (_t(k1), _t(k2), torch.from_numpy(valid), m)
    card = (_t(k1).cuda(), _t(k2).cuda(), torch.from_numpy(valid).cuda(), m)
    launches = port.insert_table.launches
    if name == "too_full":
        with pytest.raises(ValueError, match="no slot"):
            port.insert_table(*card)
        assert port.insert_table.launches == launches + 1
        return
    got = port.insert_table(*card)
    torch.cuda.synchronize()
    assert port.insert_table.launches == launches + 1
    want = port.insert_table_plain(*cpu)
    assert got[3] == want[3] and got[4] == _longest(got[:3])
    assert _contents(got[:3]) == _contents(want[:3])
    assert not got[0]._base[:, 3].any()
    q1, q2 = _queries(k1, k2)
    on_card = port.probe_table(*got[:3], _t(q1).cuda(), _t(q2).cuda(), max_probe=got[4] + 1)
    plain = port.probe_table_plain(*want[:3], _t(q1), _t(q2), max_probe=want[4] + 1)
    assert torch.equal(on_card.cpu(), plain)


@pytest.mark.cuda
def test_insert_kernel_keeps_the_smallest_row_of_each_repeated_key_on_card():
    """1M rows over 1,000 keys, built 20 times: each key holds its smallest
    row id, ``occupied`` is 1,000, and every build answers alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(11)
    k1, k2 = _keys(rng, 1000)
    pick = rng.integers(0, 1000, 1_000_000)
    a, b = _t(k1[pick]).cuda(), _t(k2[pick]).cuda()
    valid = torch.ones(len(pick), dtype=torch.bool, device="cuda")
    want = _first_rows(k1[pick], k2[pick], np.ones(len(pick), bool))
    q = (_t(k1).cuda(), _t(k2).cuda())
    first = None
    for _ in range(20):
        tk1, tk2, pay, occupied, longest = port.insert_table(a, b, valid, 4096)
        assert occupied == 1000
        assert _contents((tk1, tk2, pay)) == want
        hit = port.probe_table(tk1, tk2, pay, *q, max_probe=longest + 1)
        first = hit if first is None else first
        assert torch.equal(hit, first)
    assert hit.tolist() == [want[(int(x), int(y))] for x, y in zip(k1, k2)]


@pytest.mark.cuda
def test_insert_kernel_places_the_rows_the_capped_rounds_leave_on_card():
    """Keys 0..4,499,999 (TPC-H SF30's customers) in 2^24 slots: the
    capped rounds leave a row unplaced there; the kernel places all, and a
    probe as far as its longest displacement finds each. That longest
    depends on the schedule (15 and 16 on the card), so ``past_max_probe``
    counts the build exactly when it reaches MAX_PROBE."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    n, m = 4_500_000, 1 << 24
    k1 = torch.arange(n, dtype=torch.int32, device="cuda")
    k2 = torch.zeros(n, dtype=torch.int32, device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    past = port.insert_table.past_max_probe
    tk1, tk2, pay, occupied, longest = port.insert_table(k1, k2, valid, m)
    assert occupied == n and longest == _longest((tk1, tk2, pay))
    assert port.insert_table.past_max_probe == past + (longest >= port.MAX_PROBE)
    hit = port.probe_table(tk1, tk2, pay, k1, k2, max_probe=longest + 1)
    assert torch.equal(hit, k1)
    assert not port.build_table(k1, k2, valid, m)[3]
