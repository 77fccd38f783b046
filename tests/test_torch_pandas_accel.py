"""The port's pandas accelerator (``pandas_accel.py``, ``pandas/``) against
cudf_tpu's.

The cases of ``tests/test_pandas_accel.py`` run through both accelerators,
the port's installed with ``device="cpu"``, and so does the 49-case
battery of ``benchmarks/pandas_compat.py`` (imported, its own ``_compare``
deciding a pass): the port must pass every case, and serve without a
fallback every case the reference serves without one. Then the rules the
port adds: ``install()`` with no device raises without a card, a device
fault raised by the engine propagates and is never replayed on pandas,
and importing ``cudf_tpu_torch.pandas`` installs nothing.
"""
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu.pandas_accel as RA

import cudf_tpu_torch.pandas_accel as TA
from cudf_tpu_torch.kernels import KernelError
from cudf_tpu_torch.kernels import onehot_groupby as tonehot

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "pandas_compat_battery", REPO / "benchmarks" / "pandas_compat.py")
battery = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(battery)


@pytest.fixture(scope="module", autouse=True)
def _drop_the_reference_traces():
    """A jitted op of the reference returns the dictionary of its first
    trace (pinned in test_torch_lists.py): the traces made here are dropped
    when the module ends, so no later module decodes with its dictionaries."""
    yield
    jax.clear_caches()


def _install(which):
    return RA.install() if which == "ref" else TA.install(device="cpu")


@pytest.fixture(params=["ref", "port"])
def accel(request):
    """(accelerator module, its installed pandas facade); pandas restored
    afterwards."""
    real = sys.modules["pandas"]
    mod = RA if request.param == "ref" else TA
    try:
        yield mod, _install(request.param)
    finally:
        mod.uninstall()
        sys.modules["pandas"] = real


def _new_fallbacks(mod, before):
    return {k: v - before.get(k, 0) for k, v in mod.fallback_stats().items()
            if v != before.get(k, 0)}


# ------------------------------------------- tests/test_pandas_accel.py's cases
def test_fast_path_groupby(accel):
    mod, P = accel
    before = mod.fallback_stats()
    df = P.DataFrame({"k": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    res = df.groupby("k").sum().to_pandas()
    exp = pd.DataFrame({"k": [1, 2], "v": [4.0, 6.0]}).set_index("k")
    pd.testing.assert_frame_equal(res, exp)
    assert _new_fallbacks(mod, before) == {}


def test_fast_arith_and_mask(accel):
    mod, P = accel
    before = mod.fallback_stats()
    df = P.DataFrame({"a": [1.0, 2.0, 3.0]})
    s = df["a"] * 2 + 1
    assert len(df[s > 3.0]) == 2
    assert _new_fallbacks(mod, before) == {}


def test_fallback_interpolate(accel):
    mod, P = accel
    before = mod.fallback_stats()
    out = P.DataFrame({"a": [1.0, None, 3.0]}).interpolate()  # replays on pandas
    assert float(out["a"].to_numpy()[1]) == 2.0
    assert _new_fallbacks(mod, before).get("interpolate", 0) == 1


def test_fallback_preserves_values(accel):
    _, P = accel
    out = P.DataFrame({"a": [3, 1, 2]}).rank()  # no frame rank: replays
    pd.testing.assert_frame_equal(out._to_slow(), pd.DataFrame({"a": [3.0, 1.0, 2.0]}))


def test_mixed_chain(accel):
    mod, P = accel
    before = mod.fallback_stats()
    df = P.DataFrame({"k": [1, 1, 2], "v": [1.0, 2.0, 3.0]})
    out = df.groupby("k", as_index=False).mean()
    assert len(out.merge(df, on="k")) == 3  # a proxy argument to a fast merge
    assert _new_fallbacks(mod, before) == {}


def test_install_module(accel):
    mod, P = accel
    assert sys.modules["pandas"] is P
    import pandas as p2

    df = p2.DataFrame({"a": [1, 2]})
    assert isinstance(df, mod.DataFrame)
    assert p2.Timestamp("2020-01-01").year == 2020  # passthrough attributes


# ------------------------------------------------------------------ the battery
@pytest.mark.parametrize("case", [name for name, _ in battery.CASES])
def test_battery_case(case):
    """The port passes the case, and is fast wherever the reference is."""
    fn = dict(battery.CASES)[case]
    df, other = battery._data()
    want = fn(battery.real_pd, df.copy(), other.copy())
    real = sys.modules["pandas"]
    fast = {}
    for which, mod in (("ref", RA), ("port", TA)):
        P = _install(which)
        try:
            before = mod.fallback_stats()
            ok = battery._compare(fn(P, df, other), want)
            fast[which] = _new_fallbacks(mod, before) == {}
        finally:
            mod.uninstall()
            sys.modules["pandas"] = real
        if which == "port":
            assert ok
    assert fast["port"] or not fast["ref"], "the reference serves this case fast"


def test_battery_rates():
    """The port's rates over the whole battery, in one process as
    ``benchmarks/pandas_compat.py`` runs it: every case passes, and 47 of
    49 stay on the engine (the reference's 46 and ``groupby-size``, whose
    fast path recurses in the reference); ``pivot_table`` and the grouped
    ``apply`` replay on pandas in both."""
    df, other = battery._data()
    real = sys.modules["pandas"]
    P = TA.install(device="cpu")
    passed = fast = 0
    try:
        for _, fn in battery.CASES:
            before = TA.fallback_stats()
            passed += bool(battery._compare(fn(P, df, other),
                                            fn(battery.real_pd, df.copy(), other.copy())))
            fast += _new_fallbacks(TA, before) == {}
    finally:
        TA.uninstall()
        sys.modules["pandas"] = real
    assert passed == len(battery.CASES) == 49
    assert fast == 47, fast


# --------------------------------------------------------- the import hook
def test_meta_path_install_uninstall():
    code = textwrap.dedent("""
        import cudf_tpu_torch.pandas
        cudf_tpu_torch.pandas.install(device="cpu")
        import pandas as pd          # resolves to the proxy
        assert getattr(pd, "__cudf_tpu_accel__", False)
        import pandas.api.types as pat   # a submodule still works
        assert pat.is_integer_dtype("int64")
        df = pd.DataFrame({"a": [3, 1, 2]})
        out = df.sort_values("a")
        assert list(out.to_pandas()["a"]) == [1, 2, 3]
        assert cudf_tpu_torch.pandas.fallback_stats() == {}
        cudf_tpu_torch.pandas.uninstall()
        import pandas as real_pd
        assert not getattr(real_pd, "__cudf_tpu_accel__", False)
        print("HOOK_OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, cwd=REPO)
    assert "HOOK_OK" in r.stdout, r.stderr[-2000:]


SCRIPT = """\
import os
import cudf_tpu_torch.pandas
if "ACCEL_TEST_DEVICE" in os.environ:
    cudf_tpu_torch.pandas.install(device=os.environ["ACCEL_TEST_DEVICE"])
import pandas as pd
df = pd.DataFrame({'x': [2, 1]})
print('RUNNER', getattr(pd, '__cudf_tpu_accel__', False),
      list(df.sort_values('x').to_pandas()['x']), cudf_tpu_torch.pandas.fallback_stats())
"""


def test_module_runner(tmp_path):
    """``python -m cudf_tpu_torch.pandas script.py``; the script (and only
    the script) reads the device from the environment."""
    script = tmp_path / "user_script.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, ACCEL_TEST_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-m", "cudf_tpu_torch.pandas", str(script)],
                       capture_output=True, text=True, timeout=240, cwd=REPO, env=env)
    assert "RUNNER True [1, 2] {}" in r.stdout, (r.stdout, r.stderr[-2000:])


def test_module_runner_without_a_card_raises(tmp_path):
    """With no device chosen the runner's frames go to CUDA: on a machine
    without a card the first one raises; nothing is replayed on pandas."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    script = tmp_path / "user_script.py"
    script.write_text(SCRIPT)
    env = {k: v for k, v in os.environ.items() if k != "ACCEL_TEST_DEVICE"}
    r = subprocess.run([sys.executable, "-m", "cudf_tpu_torch.pandas", str(script)],
                       capture_output=True, text=True, timeout=240, cwd=REPO, env=env)
    assert r.returncode != 0 and "RUNNER" not in r.stdout
    assert "CUDA is not available" in r.stderr, r.stderr[-2000:]


def test_pandas_internals_see_real_objects():
    """An attribute read from a module of pandas gets the real object's
    attribute (``_pandas_internal_caller`` looks two frames up, at the
    reader); user code gets the engine's."""
    real = sys.modules["pandas"]
    P = TA.install(device="cpu")
    try:
        xdf = P.DataFrame({"a": [1, 2], "b": [3.0, 4.0]})
        inside, outside = {"__name__": "pandas.core.reader"}, {"__name__": "user_code"}
        for g in (inside, outside):
            exec("def read(o):\n    return o.groupby", g)
        assert isinstance(inside["read"](xdf).__self__, TA._pd.DataFrame)
        assert outside["read"](xdf).__name__ == "method"  # the fast path's wrapper
    finally:
        TA.uninstall()
        sys.modules["pandas"] = real


# ------------------------------------------------------ the port's own rules
def test_install_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    real = sys.modules["pandas"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.install()
    assert sys.modules["pandas"] is real


def test_importing_the_entry_installs_nothing():
    code = ("import sys, pandas, cudf_tpu_torch.pandas, cudf_tpu_torch.pandas.__main__\n"
            "assert sys.modules['pandas'] is pandas\n"
            "assert not getattr(pandas, '__cudf_tpu_accel__', False)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.stdout.strip() == "ok", r.stderr[-2000:]


@pytest.mark.parametrize("error", [KernelError("onehot_groupby_sum_count launch failed"),
                                   RuntimeError("CUDA error: an illegal memory access"),
                                   torch.OutOfMemoryError("CUDA out of memory")],
                         ids=["kernel", "cuda", "oom"])
def test_a_device_fault_propagates_and_is_not_replayed(monkeypatch, error):
    def fail(*a, **k):
        raise error

    monkeypatch.setattr(tonehot, "groupby_sum_count_plain", fail)
    real = sys.modules["pandas"]
    P = TA.install(device="cpu")
    try:
        df = P.DataFrame({"k": [1, 2, 1, 2], "v": np.arange(4, dtype=np.float32)})
        before = TA.fallback_stats()
        with pytest.raises(type(error), match=str(error)[:12]):
            df.groupby("k").sum()
        assert _new_fallbacks(TA, before) == {}
    finally:
        TA.uninstall()
        sys.modules["pandas"] = real


def _load_a_broken_library(monkeypatch):
    """The one-hot groupby loads its kernel library, whose ``dlopen`` fails."""
    import ctypes

    from cudf_tpu_torch import kernels

    def cdll(*a, **k):
        raise OSError("libonehot_groupby.so: cannot open shared object file")

    monkeypatch.setattr(kernels, "build_all", lambda names: None)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setitem(kernels._LIBS, "onehot_groupby", None)
    return lambda *a: kernels.load_library("onehot_groupby")


def _refuse_the_launch(monkeypatch):
    """The wrapper is handed tensors on a device it has no kernel for."""
    wrapper = tonehot.groupby_sum_count
    return lambda gid, vals, w, k: wrapper(gid.to("meta"), vals.to("meta"), w.to("meta"), k)


def _refuse_the_tier(monkeypatch):
    """The wrapper's shared-memory tier refuses the accumulator."""
    return lambda gid, vals, w, k: tonehot._tier(1 << 20, 8)


@pytest.mark.parametrize("fault, error, match", [
    (_load_a_broken_library, KernelError, "cannot load the onehot_groupby"),
    (_refuse_the_launch, ValueError, "no kernel for device meta"),
    (_refuse_the_tier, ValueError, "shared memory")],
    ids=["library", "device", "tier"])
def test_a_fault_raised_in_the_kernel_layer_is_not_replayed(monkeypatch, fault, error,
                                                            match):
    """Whatever the kernel layer raises, not only ``KernelError`` and CUDA's
    errors: a library that will not load (``OSError`` from ``dlopen``,
    raised as ``KernelError``), a launch the wrapper refuses."""
    monkeypatch.setattr(tonehot, "groupby_sum_count_plain", fault(monkeypatch))
    real = sys.modules["pandas"]
    P = TA.install(device="cpu")
    try:
        df = P.DataFrame({"k": [1, 2, 1, 2], "v": np.arange(4, dtype=np.float32)})
        before = TA.fallback_stats()
        with pytest.raises(error, match=match):
            df.groupby("k").sum()
        assert _new_fallbacks(TA, before) == {}
    finally:
        TA.uninstall()
        sys.modules["pandas"] = real


def test_an_unsupported_op_is_still_replayed(monkeypatch):
    """The contract stays for what the engine does not support."""
    from cudf_tpu_torch.frame import DataFrame as FastDF

    def unsupported(self, *a, **k):
        raise NotImplementedError("no fast sort here")

    monkeypatch.setattr(FastDF, "sort_values", unsupported)
    real = sys.modules["pandas"]
    P = TA.install(device="cpu")
    try:
        before = TA.fallback_stats()
        out = P.DataFrame({"a": [3, 1, 2]}).sort_values("a")
        assert list(out.to_pandas()["a"]) == [1, 2, 3]
        assert _new_fallbacks(TA, before) == {"sort_values": 1}
    finally:
        TA.uninstall()
        sys.modules["pandas"] = real


def test_reference_replays_a_device_fault_on_pandas(monkeypatch):
    """Pinned: the reference catches every exception of its engine, a CUDA
    or kernel fault included, and replays the call on pandas."""
    from cudf_tpu.frame import DataFrame as RefDF

    def fault(self, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(RefDF, "sort_values", fault)
    real = sys.modules["pandas"]
    P = RA.install()
    try:
        before = RA.fallback_stats()
        out = P.DataFrame({"a": [3, 1, 2]}).sort_values("a")
        assert list(out.to_pandas()["a"]) == [1, 2, 3]
        assert _new_fallbacks(RA, before) == {"sort_values": 1}
    finally:
        RA.uninstall()
        sys.modules["pandas"] = real


def test_module_merge_runs_on_the_engine(monkeypatch):
    """``P.merge(l, r)`` is ``l.merge(r)`` on the engine in the port (the
    hash-table lane, no fallback). Pinned: the reference leaves the
    top-level merge to pandas, whose internals index the proxies through
    ``__getitem__`` (which no caller check guards) and fail with a KeyError."""
    from cudf_tpu_torch.kernels import hashtable as tht

    probes = []
    inner = tht.probe_table
    monkeypatch.setattr(tht, "probe_table", lambda *a, **k: probes.append(1) or inner(*a, **k))
    left = pd.DataFrame({"k": np.arange(50) % 7, "v": np.arange(50.0)})
    right = pd.DataFrame({"k": np.arange(7), "w": np.arange(7) * 1.5})
    want = pd.merge(left, right, on="k")
    real = sys.modules["pandas"]
    P = RA.install()
    try:
        with pytest.raises(KeyError):
            P.merge(P.DataFrame(left), P.DataFrame(right), on="k")
    finally:
        RA.uninstall()
        sys.modules["pandas"] = real
    P = TA.install(device="cpu")
    try:
        before = TA.fallback_stats()
        assert battery._compare(P.merge(P.DataFrame(left), P.DataFrame(right), on="k"), want)
        assert battery._compare(P.merge(left, right, on="k"), want)
        assert _new_fallbacks(TA, before) == {}
        assert battery._compare(P.merge(left, right, "inner", "k"), want)
        assert _new_fallbacks(TA, before) == {"merge": 1}
    finally:
        TA.uninstall()
        sys.modules["pandas"] = real
    assert probes == [1, 1]
