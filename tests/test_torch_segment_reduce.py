"""The per-segment reduction of every groupby lane
(``cudf_tpu_torch.kernels.segment_reduce``, reached through
``ops/sortprim.py:segment_reduce``).

On the CPU: the contract on the plain path (``init`` takes part, an empty
segment reads ``init``, the overflow segment is an ordinary one,
decreasing ids raise), the wrapper's refusals, and every (reduction,
dtype, init) that a caller passes against a numpy oracle. On the card
(``cuda``): the kernel against its plain version, ``scatter_reduce_``, at
the groupby lanes' shapes: integers and min/max (NaN included) in equal
bits, float sums within the source's bound and the same bits twice; and
the flag the kernel sets where the ids break the contract.
"""
import numpy as np
import pytest
import torch

from cudf_tpu_torch.kernels import segment_reduce as K
from cudf_tpu_torch.ops.sortprim import segment_reduce

I32MAX = 2**31 - 1
CAP = 64  # a table's capacity in the callers' cases


def _ids(rng, n_rows, num_segments, pad=0):
    """Sorted ids of ``n_rows`` live rows in ``num_segments - 1`` groups (some
    empty), then ``pad`` rows in the overflow segment."""
    live = np.sort(rng.integers(0, num_segments - 1, n_rows))
    return torch.from_numpy(np.concatenate([live, np.full(pad, num_segments - 1)]))


def _oracle(vals: np.ndarray, seg: np.ndarray, num_segments: int, reduce: str, init):
    """Each segment's values folded in row order onto ``init``, in the
    values' dtype; min and max give a NaN if any operand is one."""
    out = np.full(num_segments, init, dtype=vals.dtype)
    for s in range(num_segments):
        for x in vals[seg == s]:
            if reduce == "sum":
                out[s] = out[s] + x
            elif reduce == "prod":
                out[s] = out[s] * x
            elif np.isnan(x) or np.isnan(out[s]):
                out[s] = np.nan
            else:
                out[s] = min(out[s], x) if reduce == "amin" else max(out[s], x)
    return out


# ------------------------------------------------------------ the contract
def test_init_takes_part_and_an_empty_segment_reads_it():
    seg = torch.tensor([0, 0, 2, 2, 2])
    vals = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int64)
    assert segment_reduce(vals, seg, 4, "sum", 10).tolist() == [13, 10, 22, 10]
    assert segment_reduce(vals, seg, 4, "amax", 4).tolist() == [4, 4, 5, 4]
    assert segment_reduce(vals, seg, 4, "amin", 2).tolist() == [1, 2, 2, 2]
    assert segment_reduce(vals, seg, 4, "prod", 2).tolist() == [4, 2, 120, 2]


def test_the_overflow_segment_is_an_ordinary_one():
    """Padding rows sent to the last segment reduce there like any rows."""
    seg = torch.tensor([0, 1, 1, 3, 3, 3])
    vals = torch.tensor([1.0, 2.0, 3.0, 7.0, 8.0, 9.0], dtype=torch.float64)
    got = segment_reduce(vals, seg, 4, "sum", 0.0)
    assert got.tolist() == [1.0, 5.0, 0.0, 24.0]
    assert segment_reduce(vals, seg, 4, "amin", float("inf")).tolist()[3] == 7.0


@pytest.mark.parametrize("ids", [[0, 2, 1], [3, 3, 0, 0], [1, 0]])
def test_decreasing_ids_raise(ids):
    seg = torch.tensor(ids)
    with pytest.raises(ValueError, match="non-decreasing"):
        segment_reduce(torch.ones(len(ids), dtype=torch.int64), seg, 4, "sum", 0)


def test_no_rows_and_one_row():
    empty = segment_reduce(torch.zeros(0, dtype=torch.float64),
                           torch.zeros(0, dtype=torch.int64), 3, "amax", -1.5)
    assert empty.tolist() == [-1.5, -1.5, -1.5]
    assert segment_reduce(torch.tensor([4], dtype=torch.int32), torch.tensor([1]), 2,
                          "amin", I32MAX).tolist() == [I32MAX, 4]


# ------------------------------------------------------------ the refusals
def test_refuses_a_wrong_device_dtype_or_shape():
    seg = torch.tensor([0, 1, 1])
    vals = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="different devices"):
        K.segment_reduce(vals.to("meta"), seg, 2, "sum", 0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.segment_reduce(vals.to("meta"), seg.to("meta"), 2, "sum", 0)
    with pytest.raises(TypeError, match="seg must be int64"):
        K.segment_reduce(vals, seg.to(torch.int32), 2, "sum", 0)
    with pytest.raises(TypeError, match="seg must be int64"):
        K.segment_reduce(vals, seg[None, :], 2, "sum", 0)
    for dt in (torch.bool, torch.uint16, torch.uint32, torch.uint64, torch.float16,
               torch.complex64):
        with pytest.raises(TypeError, match="no segment reduction"):
            K.segment_reduce(torch.ones(3, dtype=dt), seg, 2, "amax", 0)
    with pytest.raises(TypeError, match="vals must be"):
        K.segment_reduce(torch.ones(4, dtype=torch.float64), seg, 2, "sum", 0)
    with pytest.raises(TypeError, match="vals must be"):
        K.segment_reduce(torch.ones(3, 1, dtype=torch.float64), seg, 2, "sum", 0)
    with pytest.raises(ValueError, match="unknown reduction"):
        K.segment_reduce(vals, seg, 2, "mean", 0)


UNSERVED = [("sum", dt) for dt in (torch.int8, torch.uint8, torch.int16, torch.int32,
                                    torch.bfloat16)] + \
           [("prod", dt) for dt in (torch.int8, torch.uint8, torch.int16, torch.int32,
                                     torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("reduce,dtype", UNSERVED, ids=lambda x: str(x).replace("torch.", ""))
def test_refuses_a_pair_no_caller_passes(reduce, dtype):
    """The kernel is built for the callers' pairs only; the CPU refuses the
    others as the card does."""
    with pytest.raises(TypeError, match=f"no segment {reduce} of"):
        K.segment_reduce(torch.ones(3, dtype=dtype), torch.tensor([0, 1, 1]), 2, reduce, 0)


# ------------------------------------------------- what the callers pass
# (reduction, dtype, init) of each call in ops/groupby.py, ops/fastgroup.py
# and ops/streaming_groupby.py
CALLERS = {
    "first_pos": ("amin", torch.int64, CAP - 1),        # groupby._aggregate_impl, first
    "counts": ("sum", torch.int64, 0),                  # counts, cnt, nunique's runs
    "sum_f32": ("sum", torch.float32, 0),               # seg_sum of a float32 column
    "sum_f64": ("sum", torch.float64, 0),               # seg_sum, m2, merge_partials
    "prod_i64": ("prod", torch.int64, 1),               # product of an integer column
    "prod_f64": ("prod", torch.float64, 1),
    "min_bool": ("amin", torch.int8, 127),              # _reducible(bool) -> int8
    "max_bool": ("amax", torch.int8, -128),
    "max_u8": ("amax", torch.uint8, 0),
    "min_i16": ("amin", torch.int16, 32767),
    "min_i32": ("amin", torch.int32, I32MAX),
    "max_i64": ("amax", torch.int64, -2**63),           # also uint64 through the signed domain
    "min_f32": ("amin", torch.float32, float("inf")),
    "max_f64": ("amax", torch.float64, float("-inf")),  # grouped_corr's flat test
    "min_bf16": ("amin", torch.bfloat16, float("inf")),
    "any": ("amax", torch.int32, 0),
    "all": ("amin", torch.int32, 1),
    "sfirst": ("amin", torch.int64, I32MAX),            # fastgroup first, argmin
    "slast": ("amax", torch.int64, -1),
    "last_pos": ("amax", torch.int64, 0),               # groupby last
}


def _values(rng, name, dtype, n):
    if name in ("any", "all"):
        return torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.integers(-8, 9, n).astype(np.float64) / 4)  # exact sums
        if name in ("min_f32", "max_f64"):
            x[rng.integers(0, n, 2)] = float("nan")
        return x.to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = (0, CAP) if name in ("first_pos", "sfirst", "slast", "last_pos", "counts") \
        else (-3, 4) if name == "prod_i64" else (max(info.min, -50), min(info.max, 50))
    return torch.from_numpy(rng.integers(lo, hi, n)).to(dtype)


@pytest.mark.parametrize("name", list(CALLERS))
def test_each_callers_dtype_and_kind_gives_the_fold_in_row_order(name):
    reduce, dtype, init = CALLERS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    nseg = 9
    seg = _ids(rng, 40, nseg, pad=CAP - 40)
    vals = _values(rng, name, dtype, CAP)
    if reduce == "prod" and dtype.is_floating_point:
        vals = torch.where(vals == 0, 1.0, vals).to(dtype)
    got = segment_reduce(vals, seg, nseg, reduce, init)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:  # numpy has none: every value here is exact in float32
        got, vals = got.float(), vals.float()
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle(vals.numpy(), seg.numpy(), nseg, reduce, init))


# ---------------------------------------------------------------- the card
def _levels(n: int) -> int:
    """Launches of the kernel on n rows: one a level of carries."""
    tiles, levels = -(-n // 4096), 1
    while tiles > 1:
        tiles, levels = -(-(2 * tiles) // 4096), levels + 1
    return levels


def _lengths(shape: str, gen) -> tuple:
    """(group lengths of the live rows, overflow rows, segments) of a shape."""
    if shape == "one_segment_2^26":
        return torch.tensor([1 << 26]), 0, 1
    if shape == "4_groups":
        return torch.tensor([15_000_001, 14_999_999, 20_000_000, 10_000_003]), 0, 5
    if shape == "q6_10000_groups_34M_overflow":
        live = torch.full((10_000,), 10_000)
        return live, (1 << 27) - 100_000_000, 10_001
    if shape == "1e6_groups":
        return torch.randint(1, 200, (1_000_000,), generator=gen), 1 << 20, 1_000_001
    if shape == "singletons":
        return torch.ones(3_000_017, dtype=torch.int64), 0, 3_000_017
    if shape == "one_segment_across_many_tiles":
        return torch.tensor([5, 4096 * 300 + 17, 3, 70_001, 1]), 777, 6
    if shape == "ragged_with_empty_groups":
        lengths = torch.randint(0, 9000, (997,), generator=gen)
        return lengths, 4096 * 3 + 77, 998
    raise KeyError(shape)


CARD_SHAPES = ["one_segment_2^26", "4_groups", "q6_10000_groups_34M_overflow",
               "1e6_groups", "singletons", "one_segment_across_many_tiles",
               "ragged_with_empty_groups"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_against_scatter_reduce_on_the_card(shape):
    """The plain version runs on the CPU copies of the inputs: on the card
    its atomics contend for one address a segment, for minutes at these
    shapes (a compare-and-swap loop a row for 8 and 16 bit and float min
    and max). Every dtype on the shapes up to 2^24 rows; int64, float64
    and float32 above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only there")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(sum(map(ord, shape)))
    lengths, pad, nseg = _lengths(shape, gen)
    seg_h = torch.repeat_interleave(torch.arange(lengths.numel()), lengths)
    seg_h = torch.cat([seg_h, torch.full((pad,), nseg - 1)])
    seg = seg_h.to(dev)
    n = seg.numel()
    before = K.segment_reduce.launches
    calls = 0

    def kernel(x, reduce, init, s=seg):
        nonlocal calls
        calls += 1
        return K.segment_reduce(x, s, nseg, reduce, init).cpu()

    def check(x_h, reduce, init):
        got = kernel(x_h.to(dev), reduce, init)
        want = K.segment_reduce_plain(x_h, seg_h, nseg, reduce, init)
        assert torch.equal(_bits(got), _bits(want)), (shape, x_h.dtype, reduce)

    # integers and min/max: the same bits
    ints = torch.randint(-2**40, 2**40, (n,), generator=gen)
    for reduce, init in (("sum", 0), ("amin", 2**63 - 1), ("amax", -1)):
        check(ints, reduce, init)
    check(ints % 3 - 1, "prod", 1)
    f = torch.randn(n, generator=gen, dtype=torch.float64)
    f[torch.randint(0, n, (7,), generator=gen)] = float("nan")
    small = n <= 1 << 24
    floats = (torch.float64, torch.float32, torch.bfloat16) if small else (torch.float64,
                                                                           torch.float32)
    for dtype in floats:
        for reduce, init in (("amin", float("inf")), ("amax", float("-inf"))):
            check(f.to(dtype), reduce, init)
    if small:
        for dtype in (torch.int8, torch.uint8, torch.int16, torch.int32):
            for reduce, init in (("amin", 127), ("amax", 0)):
                check((ints % 200 - 1).to(dtype), reduce, init)
    # an unaligned view: the scalar loads
    got = kernel(ints.to(dev)[1:], "amax", -1, seg[1:])
    assert torch.equal(got, K.segment_reduce_plain(ints[1:], seg_h[1:], nseg, "amax", -1))

    # float64 sums: k / 2^20, so the int64 sum of k is the exact sum
    d = 29 * _levels(n) + 1
    k = torch.randint(-2**36, 2**36, (n,), generator=gen)
    x = (k.to(torch.float64) / 2**20).to(dev)
    got = kernel(x, "sum", 0.0)
    exact = K.segment_reduce_plain(k, seg_h, nseg, "sum", 0).to(torch.float64) / 2**20
    absum = K.segment_reduce_plain(k.abs(), seg_h, nseg, "sum", 0).to(torch.float64) / 2**20
    bound = d * 2.0**-53 * absum * 1.01 + exact.abs() * 2.0**-53
    assert bool(((got - exact).abs() <= bound).all()), shape
    assert torch.equal(_bits(got), _bits(kernel(x, "sum", 0.0)))
    # float32 sums against float64 ones of the same values
    x32 = torch.randn(n, generator=gen)
    got = kernel(x32.to(dev), "sum", 0.0)
    ref = K.segment_reduce_plain(x32.double(), seg_h, nseg, "sum", 0.0)
    absum = K.segment_reduce_plain(x32.double().abs(), seg_h, nseg, "sum", 0.0)
    bound = d * 2.0**-24 * absum * 1.01 + ref.abs() * 2.0**-24
    assert bool(((got.double() - ref).abs() <= bound).all()), shape
    assert torch.equal(_bits(got), _bits(kernel(x32.to(dev), "sum", 0.0)))
    assert K.segment_reduce.launches - before == calls
    assert not K.contract_broken()


@pytest.mark.cuda
def test_the_card_flags_ids_that_break_the_contract():
    """Ids that decrease inside a thread's rows, between two threads,
    between two tiles, or that leave [0, num_segments), set the flag that
    contract_broken() reads and clears; sorted ids leave it clear."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only there")
    dev = torch.device("cuda")
    n = 4096 * 5 + 3
    seg = torch.arange(n, device=dev) // 7
    nseg = int(seg[-1]) + 1
    vals = torch.ones(n, dtype=torch.float64, device=dev)
    K.contract_broken()
    K.segment_reduce(vals, seg, nseg, "sum", 0.0)
    assert not K.contract_broken()
    # in a thread, across threads, across tiles, in the last (ragged) tile
    for at in (21, 32, 4096, n - 2):
        bad = seg.clone()
        bad[at] = bad[at - 1] - 1
        K.segment_reduce(vals, bad, nseg, "sum", 0.0)
        assert K.contract_broken(), at
        assert not K.contract_broken()
    for out_of_range in (-1, nseg):
        bad = seg.clone()
        bad[0 if out_of_range < 0 else -1] = out_of_range
        K.segment_reduce(vals, bad, nseg, "amax", float("-inf"))
        assert K.contract_broken(), out_of_range
