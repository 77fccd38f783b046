"""The port's one-hot groupby kernel function against the Pallas reference.

``cudf_tpu_torch.kernels.onehot_groupby.groupby_sum_count`` on CPU tensors
runs its plain PyTorch version; the reference ``groupby_sum_count`` runs in
Pallas interpret mode on the CPU. Same numpy inputs, made from a seed.
Tolerance: rtol 2e-4 / atol 1e-3 on sums (tests/test_kernels.py:58) — the
reference accumulates in f32, the port in f64. Counts of 0/1 weights must
be exactly equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudf_tpu.kernels import onehot_groupby as ref
from cudf_tpu_torch.kernels import onehot_groupby as port

RTOL, ATOL = 2e-4, 1e-3


def _case(name):
    """(gid i32[N], vals f32[N, V], weight f32[N], K, weights_are_01)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "test_kernels_37_groups":  # tests/test_kernels.py:46-61
        n, K, V = 10_000, 37, 2
        gid = rng.integers(0, K, n)
        w = (rng.random(n) > 0.1).astype(np.float32)
    elif name == "test_kernels_multiple_tiles":  # tests/test_kernels.py:64-70
        n, K, V = 5000, 5, 1
        gid = np.arange(n) % K
        w = np.ones(n, np.float32)
    elif name == "ragged_tail":
        n, K, V = 3 * 2048 + 77, 16, 1
        gid = rng.integers(0, K, n)
        w = (rng.random(n) > 0.3).astype(np.float32)
    elif name == "zero_weights":
        n, K, V = 3000, 8, 1
        gid = rng.integers(0, K, n)
        w = np.zeros(n, np.float32)
        w[::7] = 1.0
    elif name == "non_01_weights":  # pins the squared weight
        n, K, V = 4000, 11, 2
        gid = rng.integers(0, K, n)
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    elif name == "one_group":
        n, K, V = 2500, 1, 1
        gid = np.zeros(n, np.int64)
        w = np.ones(n, np.float32)
    elif name == "k2048":
        n, K, V = 6000, 2048, 1
        gid = rng.integers(0, K, n)
        w = np.ones(n, np.float32)
    elif name == "gids_out_of_range":
        n, K, V = 3000, 16, 1
        gid = rng.integers(-4, K + 4, n)
        w = np.ones(n, np.float32)
    else:  # pragma: no cover
        raise KeyError(name)
    vals = rng.standard_normal((n, V)).astype(np.float32)
    return gid.astype(np.int32), vals, w, K, name != "non_01_weights"


CASES = ["test_kernels_37_groups", "test_kernels_multiple_tiles", "ragged_tail",
         "zero_weights", "non_01_weights", "one_group", "k2048",
         "gids_out_of_range"]


@pytest.mark.parametrize("name", CASES)
def test_groupby_sum_count_matches_pallas(name):
    gid, vals, w, K, is01 = _case(name)
    want = np.asarray(ref.groupby_sum_count(jnp.asarray(gid), jnp.asarray(vals),
                                            jnp.asarray(w), K))
    got = port.groupby_sum_count(torch.from_numpy(gid), torch.from_numpy(vals),
                                 torch.from_numpy(w), K)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    got = got.numpy()
    V = vals.shape[1]
    np.testing.assert_allclose(got[:, :V], want[:, :V], rtol=RTOL, atol=ATOL)
    if is01:
        np.testing.assert_array_equal(got[:, V], want[:, V])
    else:
        np.testing.assert_allclose(got[:, V], want[:, V], rtol=RTOL, atol=ATOL)
    # and the function itself, in f64 from numpy: out[k] = sum w*(w*v), sum w*w
    ok = (gid >= 0) & (gid < K)
    exp = np.zeros((K, V + 1))
    c = np.concatenate([(vals * w[:, None]) * w[:, None], (w * w)[:, None]], 1)
    np.add.at(exp, gid[ok], c[ok].astype(np.float64))
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-9)


def test_groupby_low_cardinality_matches_pallas():
    rng = np.random.default_rng(1)
    n, K = 10_000, 37
    gid = rng.integers(0, K, n).astype(np.int32)
    v1 = rng.standard_normal(n).astype(np.float32)
    v2 = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) > 0.1
    rs, rc = ref.groupby_low_cardinality(jnp.asarray(gid), [jnp.asarray(v1), jnp.asarray(v2)],
                                         [jnp.asarray(valid)], K)
    ps, pc = port.groupby_low_cardinality(torch.from_numpy(gid),
                                          [torch.from_numpy(v1), torch.from_numpy(v2)],
                                          [torch.from_numpy(valid)], K)
    for r, p in zip(rs, ps):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("bad", ["gid_dtype", "vals_rank", "weight_shape",
                                 "too_many_groups", "no_groups", "devices",
                                 "accumulator_past_48kb"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    n = 64
    gid = torch.zeros(n, dtype=torch.int32)
    vals = torch.zeros(n, 1)
    w = torch.ones(n)
    K = 4
    if bad == "gid_dtype":
        gid = gid.to(torch.int64)
    elif bad == "vals_rank":
        vals = vals[:, 0]
    elif bad == "weight_shape":
        w = w[:10]
    elif bad == "too_many_groups":
        K = port.MAX_GROUPS + 1
    elif bad == "no_groups":
        K = 0
    elif bad == "devices":
        vals = vals.to("meta")
    elif bad == "accumulator_past_48kb":
        # 2048 * 10 * 4 B = 80 KB of f32 per warp copy; with the f64 total,
        # 240 KB for one warp: past a block's 227 KB, so neither tier holds it
        K, vals = port.MAX_GROUPS, torch.zeros(n, 9)
    with pytest.raises((TypeError, ValueError)):
        port._check(gid, vals, w, K)


# (K, V, warps): the register tier (0) up to K·(V+1) = 32, the shared tier
# past it, with fewer warps a block where 8 copies of [K, V+1] do not fit
TIERS = [(16, 1, 0), (32, 0, 0), (1, 31, 0), (11, 2, 8), (33, 0, 8), (2048, 1, 8),
         (2048, 2, 7), (2048, 8, 1)]


@pytest.mark.parametrize("K,V,warps", TIERS)
def test_wrapper_picks_the_tier_from_the_accumulator_size(K, V, warps):
    assert port._tier(K, V) == warps
    port._check(torch.zeros(8, dtype=torch.int32), torch.zeros(8, V), torch.ones(8), K)


@pytest.mark.parametrize("K,V", [(2048, 9), (1024, 19), (1, 19370)])
def test_wrapper_refuses_only_what_neither_tier_holds(K, V):
    with pytest.raises(ValueError, match="shared memory"):
        port._tier(K, V)
    with pytest.raises(ValueError, match="shared memory"):
        port._check(torch.zeros(8, dtype=torch.int32), torch.zeros(8, V), torch.ones(8), K)


def _nan_case():
    """Four groups, one NaN value in group 2; ragged N."""
    rng = np.random.default_rng(11)
    n, K = 4099, 4
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.standard_normal((n, 1)).astype(np.float32)
    vals[np.flatnonzero(gid == 2)[3], 0] = np.nan
    return gid, vals, np.ones(n, np.float32), K


def test_plain_version_keeps_nan_in_its_group():
    gid, vals, w, K = _nan_case()
    got = port.groupby_sum_count(torch.from_numpy(gid), torch.from_numpy(vals),
                                 torch.from_numpy(w), K).numpy()
    assert np.isnan(got[2, 0]) and np.isfinite(np.delete(got[:, 0], 2)).all()
    exp = np.array([vals[gid == k, 0].astype(np.float64).sum() for k in range(K)])
    np.testing.assert_allclose(np.delete(got[:, 0], 2), np.delete(exp, 2), rtol=1e-12)
    np.testing.assert_array_equal(got[:, 1], np.bincount(gid, minlength=K))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises: here a meta
    tensor, for which no kernel exists, must raise."""
    n = 64
    args = (torch.zeros(n, dtype=torch.int32, device="meta"),
            torch.zeros(n, 1, device="meta"), torch.ones(n, device="meta"))
    before = port.groupby_sum_count.launches
    with pytest.raises(ValueError, match="no kernel"):
        port.groupby_sum_count(*args, 4)
    assert port.groupby_sum_count.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    gid, vals, w, K, is01 = _case(name)
    args = [torch.from_numpy(a).cuda() for a in (gid, vals, w)]
    before = port.groupby_sum_count.launches
    got = port.groupby_sum_count(*args, K)
    torch.cuda.synchronize()
    assert port.groupby_sum_count.launches == before + 1
    want = port.groupby_sum_count_plain(*args, K)
    V = vals.shape[1]
    # f32 tile sums add in another order than the plain version's f64: rtol 1e-5
    torch.testing.assert_close(got[:, :V], want[:, :V], rtol=1e-5, atol=1e-4)
    if is01:
        assert torch.equal(got[:, V], want[:, V])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("K,V,warps", TIERS)
@pytest.mark.parametrize("offset", [0, 1])
def test_both_tiers_match_plain_on_card_and_repeat_bit_for_bit(K, V, warps, offset):
    """Each tier at its edges, on 16 B-aligned bases and on bases one row
    off (the scalar head); two launches give the same bits."""
    _card()
    rng = np.random.default_rng(K * 100 + V)
    n = 3 * 8192 + 77 + offset
    gid = torch.from_numpy(rng.integers(-2, K + 2, n).astype(np.int32)).cuda()[offset:]
    vals = torch.from_numpy(rng.standard_normal((n, V)).astype(np.float32)).cuda()[offset:]
    w = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32)).cuda()[offset:]
    got = port.groupby_sum_count(gid, vals, w, K)
    again = port.groupby_sum_count(gid, vals, w, K)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = port.groupby_sum_count_plain(gid, vals, w, K)
    scale = port.groupby_sum_count_plain(gid, vals.abs(), w, K)
    assert bool(((got[:, :V] - want[:, :V]).abs() <= 1e-5 * scale[:, :V] + 1e-6).all())
    assert torch.equal(got[:, V], want[:, V])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 64])  # register tier, shared tier
def test_kernel_keeps_nan_in_its_group_on_card(K):
    _card()
    gid, vals, w, _ = _nan_case()
    got = port.groupby_sum_count(*[torch.from_numpy(a).cuda() for a in (gid, vals, w)], K)
    got = got.cpu().numpy()
    assert np.isnan(got[2, 0])
    assert np.isfinite(np.delete(got[:, 0], 2)).all() and np.isfinite(got[:, 1]).all()
