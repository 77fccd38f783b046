"""The port's filling, labeling and reshape ops (``cudf_tpu_torch/ops/
filling.py``) against cudf_tpu's and pandas.

Columns made from a seed with numpy go through both packages (the port on
the CPU): sequences, fill, label_bins against pandas.cut, transpose, tile,
repeat, one-hot encoding, qcut labels and the forward and backward fills
of ints with nulls, floats with NaN and nulls, and strings. Every value
and null mask is exact.
"""
import jax
import numpy as np
import pandas as pd
import pytest

import cudf_tpu as ct
from cudf_tpu.ops import filling as rfill

import cudf_tpu_torch as tt
from cudf_tpu_torch.ops import filling as tfill


def _same(got, want):
    g, w = got.to_pandas(), want.to_pandas()
    pd.testing.assert_series_equal(g, w, check_dtype=False)


@pytest.mark.parametrize("init,step,dtype", [(0, 1, "int64"), (10, 2, "int64"),
                                             (-5, 3, "int32"), (0.5, 0.25, "float64")])
def test_sequence_and_fill(init, step, dtype):
    rdt, tdt = getattr(ct.dtypes, dtype), getattr(tt.dtypes, dtype)
    r = rfill.sequence(300, init, step, rdt)
    t = tfill.sequence(300, init, step, tdt, device="cpu")
    _same(t, r)
    np.testing.assert_array_equal(t.to_numpy(), (np.arange(300) * step + init).astype(dtype))
    _same(tfill.fill(t, 3, 40, 99), rfill.fill(r, 3, 40, 99))
    _same(tfill.fill(t, 100, 120, None), rfill.fill(r, 100, 120, None))


@pytest.mark.parametrize("right,include_lowest", [(True, True), (True, False),
                                                  (False, True)])
def test_label_bins_matches_cut(right, include_lowest):
    rng = np.random.default_rng(0)
    x = rng.uniform(-10, 110, 500)
    x[:5] = [0, 25, 50, 100, np.nan]
    edges = [0, 25, 50, 75, 100]
    got = tfill.label_bins(tt.Column.from_numpy(x, device="cpu"), edges, right,
                           include_lowest)
    want = rfill.label_bins(ct.Column.from_numpy(x), edges, right, include_lowest)
    _same(got, want)
    cut = pd.cut(x, edges, right=right, labels=False, include_lowest=include_lowest)
    np.testing.assert_array_equal(got.to_pandas().to_numpy(np.float64), cut)


def test_reshape_ops():
    pdf = pd.DataFrame({"a": [1, 2, 3], "b": [4, 5, 6]})
    r, t = ct.Table.from_pandas(pdf), tt.Table.from_pandas(pdf, device="cpu")
    for fn, args in ((rfill.transpose, ()), (rfill.tile, (3,)), (rfill.repeat, (4,))):
        want = fn(r, *args).to_pandas()
        got = getattr(tfill, fn.__name__)(t, *args).to_pandas()
        pd.testing.assert_frame_equal(got, want)
    np.testing.assert_array_equal(tfill.repeat(t, 2)["a"].to_numpy(), [1, 1, 2, 2, 3, 3])


def test_one_hot_and_qcut():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 4, 200)
    got = tfill.one_hot_encode(tt.Column.from_numpy(v, device="cpu")).to_pandas()
    want = rfill.one_hot_encode(ct.Column.from_numpy(v)).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    x = rng.normal(size=500)
    got = tfill.qcut_labels(tt.Column.from_numpy(x, device="cpu"), 4)
    _same(got, rfill.qcut_labels(ct.Column.from_numpy(x), 4))
    np.testing.assert_array_equal(got.to_numpy(), pd.qcut(x, 4, labels=False))


def _fill_inputs(kind, rng, n=300):
    if kind == "float_nan":
        x = rng.normal(size=n)
        x[rng.random(n) < 0.3] = np.nan
        x[:3] = np.nan  # leading: nothing to carry
        return pd.Series(x)
    if kind == "int_nulls":
        s = pd.Series(pd.array(rng.integers(0, 9, n), dtype="Int64"))
        s[rng.random(n) < 0.3] = pd.NA
        s[n - 3:] = pd.NA  # trailing: nothing to carry back
        return s
    s = pd.Series(rng.choice(["a", "b", "c"], n).astype(object))
    s[rng.random(n) < 0.3] = None
    return s


@pytest.mark.parametrize("kind", ["float_nan", "int_nulls", "str_nulls"])
def test_fill_forward_backward(kind):
    s = _fill_inputs(kind, np.random.default_rng(2))
    pdf = pd.DataFrame({"x": s})
    r = ct.Table.from_pandas(pdf)["x"]
    t = tt.Table.from_pandas(pdf, device="cpu")["x"]
    # the reference's fills keep the dictionary of their first trace at a
    # shape (pinned below): a fresh trace makes its answer this column's
    jax.clear_caches()
    for tf, rf, pf in ((tfill.fill_forward, rfill.fill_forward, s.ffill),
                       (tfill.fill_backward, rfill.fill_backward, s.bfill)):
        got = tf(t)
        _same(got, rf(r))
        g, w = got.to_pandas(), pf()
        np.testing.assert_array_equal(g.isna().to_numpy(), w.isna().to_numpy())
        np.testing.assert_array_equal(g[g.notna()].to_numpy(np.dtype(object)).astype(str),
                                      w[w.notna()].to_numpy(np.dtype(object)).astype(str))


def test_reference_fill_keeps_first_traced_dictionary():
    """A fault of the reference, pinned: its jitted fills carry a string
    column's dictionary as static trace data that compares equal for every
    dictionary, so a second column of the same shape gets the first one's
    strings back. The port's fills keep each column's own dictionary."""
    def col(P, vals, **kw):
        return P.Table.from_pandas(pd.DataFrame({"x": pd.Series(vals, dtype=object)}),
                                   **kw)["x"]

    first, second = ["p", None, "q", "r"] * 75, ["a", None, "b", "c"] * 75
    want = pd.Series(second, dtype=object).ffill()
    jax.clear_caches()
    rfill.fill_forward(col(ct, first))
    ref = rfill.fill_forward(col(ct, second)).to_pandas()
    assert ref[:4].tolist() == ["p", "p", "q", "r"]
    got = tfill.fill_forward(col(tt, second, device="cpu")).to_pandas()
    assert got.tolist() == want.tolist()
