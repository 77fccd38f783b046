"""Zero-code-change pandas accelerator: the fast/slow proxy layer.

Counterpart of ``cudf_tpu/pandas_accel.py`` (cudf.pandas: python/cudf/cudf/
pandas/fast_slow_proxy.py:563-604 proxy types, :1291
_fast_slow_function_call, try fast and replay on slow). ``install()``
returns a module object that mimics ``pandas``: DataFrame/Series
constructors and top-level functions give proxy objects that run on the
cudf_tpu_torch engine when the operation is supported, and replay on real
pandas (device to host, then the pandas call) otherwise.

Usage:
    import cudf_tpu_torch.pandas_accel as xpd
    pd = xpd.install()                    # CUDA; install(device="cpu") for the CPU
    df = pd.DataFrame({...})
    out = df.groupby("k").mean()          # runs on the card
    out2 = df.pivot_table(...)            # replays on pandas

or run a script unchanged: ``python -m cudf_tpu_torch.pandas script.py``.

Two rules the reference does not have:

- Every ingest goes to the device ``install`` was given (CUDA by default;
  ``install`` raises when there is no card), so a proxy never reaches for
  a device the caller did not ask for.
- Replaying on pandas is the contract for an operation the engine does
  not support, not for a fault of the device layer: whatever the kernel
  layer raises (a kernel that fails to build, load or launch, a launch it
  refuses), a CUDA error or a missing card propagates from the proxy call
  and is never replayed.
"""
from __future__ import annotations

import sys
import types
from typing import Any

import numpy as np
import torch

from .core.column import resolve_device
from .frame import DataFrame as _FastDF, Series as _FastSeries, concat as _fast_concat
from .kernels import KernelError
from .utils.real_pandas import pd as _pd

_FALLBACKS: dict = {}
_DEVICE = None  # the device of every ingest, set by install()


def _record_fallback(name: str):
    _FALLBACKS[name] = _FALLBACKS.get(name, 0) + 1


def fallback_stats() -> dict:
    """How often each pandas method fell back to the host (the cudf.pandas
    profiler analog, python/cudf/cudf/pandas/profiler.py)."""
    return dict(_FALLBACKS)


def _device() -> torch.device:
    return _DEVICE if _DEVICE is not None else resolve_device(None)


_KERNELS = KernelError.__module__  # "cudf_tpu_torch.kernels"


def _raised_in_kernels(e: BaseException) -> bool:
    """Whether ``e``, or an exception it was raised from or while handling,
    came out of a frame of the kernel layer (``cudf_tpu_torch.kernels``):
    a library that would not load, a wrapper that refused a launch."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        tb = e.__traceback__
        while tb is not None:
            if tb.tb_frame.f_globals.get("__name__", "").startswith(_KERNELS):
                return True
            tb = tb.tb_next
        e = e.__cause__ or e.__context__
    return False


def _replayable(e: Exception) -> bool:
    """False for a fault of the device layer: anything the kernel layer
    raised (a build, a load, a launch or a refused launch), a CUDA error,
    device memory, a missing card. Those propagate."""
    accel_error = getattr(torch, "AcceleratorError", None)
    if isinstance(e, (KernelError, torch.OutOfMemoryError)) or (
            accel_error is not None and isinstance(e, accel_error)):
        return False
    if isinstance(e, RuntimeError) and "CUDA" in str(e):
        return False
    return not _raised_in_kernels(e)


def _is_proxy(obj: Any) -> bool:
    # isinstance() is unreliable once proxies lie about __class__ (the
    # cudf.pandas trick, fast_slow_proxy.py:563): check the real MRO
    return _ProxyBase in type(obj).__mro__


def _wrap(obj: Any):
    if _is_proxy(obj):
        return obj
    if isinstance(obj, _pd.DataFrame):
        try:
            return XDataFrame._from_fast(_FastDF.from_pandas(obj, device=_device()), slow=obj)
        except Exception as e:
            if not _replayable(e):
                raise
            _record_fallback("wrap.DataFrame")
            return XDataFrame._from_fast(None, slow=obj)
    if isinstance(obj, _pd.Series):
        try:
            return XSeries._from_fast(_FastSeries(obj, device=_device()), slow=obj)
        except Exception as e:
            if not _replayable(e):
                raise
            _record_fallback("wrap.Series")
            return XSeries._from_fast(None, slow=obj)
    return obj


def _unproxy_fast(a):
    """Device-side view of an argument tree (proxies -> fast objects)."""
    if isinstance(a, _ProxyBase):
        f = a._fast_obj()
        return f if f is not None else a._to_slow()
    if isinstance(a, (list, tuple)):
        return type(a)(_unproxy_fast(x) for x in a)
    if isinstance(a, dict):
        return {k: _unproxy_fast(v) for k, v in a.items()}
    return a


def _unproxy_slow(a):
    """Host-side view of an argument tree (proxies -> real pandas objects),
    the cudf.pandas _transform_arg analog (fast_slow_proxy.py:1380)."""
    if isinstance(a, (_ProxyBase, XIndex)):
        return a._to_slow()
    if type(a).__module__.startswith("cudf_tpu_torch") and hasattr(a, "to_pandas"):
        return a.to_pandas()
    if isinstance(a, (list, tuple)):
        return type(a)(_unproxy_slow(x) for x in a)
    if isinstance(a, dict):
        return {k: _unproxy_slow(v) for k, v in a.items()}
    return a


def _slow_args(args, kwargs):
    return ([_unproxy_slow(a) for a in args],
            {k: _unproxy_slow(v) for k, v in kwargs.items()})


def _pandas_internal_caller() -> bool:
    """True when the attribute access comes from inside real pandas
    (pandas.* but pandas.tests.*) or numpy. Those frames must only ever see
    real pandas objects; the proxy enforces that where an attribute is
    read. Frame 2 is the reader: frame 1 is the ``__getattr__`` that calls
    this, so call it from nowhere else."""
    try:
        mod = sys._getframe(2).f_globals.get("__name__", "")
    except ValueError:
        return False
    if mod == "numpy" or mod.startswith("numpy."):
        return True
    return (mod == "pandas" or mod.startswith("pandas.")) and \
        not mod.startswith("pandas.tests")


_UNSET = object()  # lazy-ingest sentinel


class _ProxyBase:
    """Try fast, else replay on pandas.

    Proxies built by the user hold the real pandas object (exact pandas
    construction) and ingest to the device on their first fast operation;
    proxies the engine returns hold the fast object and build the pandas
    form on first host need (fast_slow_proxy.py:563-604's paired
    attributes, converted lazily both ways)."""

    _fast = None   # cudf_tpu_torch object, None (host only) or _UNSET (lazy)
    _slow = None   # cached pandas object

    @classmethod
    def _from_fast(cls, fast, slow=None):
        o = object.__new__(cls)
        o._fast = fast
        o._slow = slow
        return o

    def _fast_obj(self):
        f = object.__getattribute__(self, "_fast")
        if f is _UNSET:
            try:
                f = type(self)._ingest(self._slow)
            except Exception as e:
                if not _replayable(e):
                    raise
                _record_fallback(f"ingest.{type(self).__name__}")
                f = None
            self._fast = f
        return f

    def _to_slow(self):
        if self._slow is None:
            self._slow = self._fast.to_pandas()
        return self._slow

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self._to_slow())
        return out.astype(dtype) if dtype is not None else out

    def _rewrap(self, result):
        if _is_proxy(result):
            return result
        if isinstance(result, _pd.DataFrame):
            return XDataFrame._from_fast(None, slow=result)
        if isinstance(result, _pd.Series):
            return XSeries._from_fast(None, slow=result)
        return result

    def __getattr__(self, name):
        # 0) real-pandas and numpy internals see only real pandas objects
        if _pandas_internal_caller():
            return getattr(self._to_slow(), name)
        # indexers replay on the slow object (exact loc/iloc semantics);
        # writes mutate it and drop the fast copy
        if name in ("loc", "iloc", "at", "iat"):
            return _IndexerProxy(self, name)
        # 1) the fast engine
        fast = self._fast_obj()
        if fast is not None and hasattr(fast, name):
            attr = getattr(fast, name)
            if not callable(attr):
                return self._rewrap_fast(attr)

            def method(*args, **kwargs):
                try:
                    out = attr(*[_unproxy_fast(a) for a in args],
                               **{k: _unproxy_fast(v) for k, v in kwargs.items()})
                    return self._rewrap_fast(out)
                except Exception as e:
                    if not _replayable(e):
                        raise
                    _record_fallback(name)
                    a, k = _slow_args(args, kwargs)
                    return self._rewrap(getattr(self._to_slow(), name)(*a, **k))

            return method
        # 2) the pandas fallback
        _record_fallback(name)
        attr = getattr(self._to_slow(), name)
        if callable(attr) and not isinstance(attr, type):
            def slow_method(*args, **kwargs):
                a, k = _slow_args(args, kwargs)
                return self._rewrap(attr(*a, **k))

            return slow_method
        return self._rewrap(attr)

    def _rewrap_fast(self, out):
        if isinstance(out, _FastDF):
            return XDataFrame._from_fast(out)
        if isinstance(out, _FastSeries):
            return XSeries._from_fast(out)
        from .frame import index as _index_mod
        from .frame.groupby import DataFrameGroupBy

        if isinstance(out, DataFrameGroupBy):
            return _GroupByProxy(out, self)
        if isinstance(out, (_index_mod.Index, _index_mod.RangeIndex, _index_mod.MultiIndex)):
            return XIndex(out)
        if isinstance(out, (list, tuple)):
            return type(out)(self._rewrap_fast(x) for x in out)
        # nothing of the fast layer may leak: any other cudf_tpu_torch
        # object converts to its pandas form
        if type(out).__module__.startswith("cudf_tpu_torch"):
            for conv in ("to_pandas", "to_numpy"):
                f = getattr(out, conv, None)
                if f is not None:
                    return self._rewrap(f())
        return out

    def __repr__(self):
        return repr(self._to_slow())

    def __len__(self):
        f = object.__getattribute__(self, "_fast")
        if f is not None and f is not _UNSET:
            return len(f)
        return len(self._to_slow())


class _IndexerProxy:
    """loc/iloc/at/iat served from the slow object; writes drop the fast
    copy (fast_slow_proxy's _FastSlowAttribute, fast_slow_proxy.py:1291)."""

    def __init__(self, parent, name):
        self._parent = parent
        self._name = name

    def __getitem__(self, key):
        attr = getattr(self._parent._to_slow(), self._name)
        return self._parent._rewrap(attr[_unproxy_slow(key)])

    def __setitem__(self, key, value):
        slow = self._parent._to_slow()
        getattr(slow, self._name)[_unproxy_slow(key)] = _unproxy_slow(value)
        self._parent._fast = None  # stale after the in-place write
        self._parent._slow = slow


class _XMeta(type):
    """isinstance(real pandas object, proxy class) is True (the
    fast_slow_proxy metaclass trick): code that type-checks against
    pd.DataFrame keeps working when pd.DataFrame is the proxy class."""

    _real: type = object

    def __instancecheck__(cls, obj):
        return type.__instancecheck__(cls, obj) or isinstance(obj, cls._real)

    def __subclasscheck__(cls, sub):
        return type.__subclasscheck__(cls, sub) or (
            isinstance(sub, type) and issubclass(sub, cls._real))

    def __getattr__(cls, name):
        # class attributes (pd.Series.nunique as an agg callable,
        # pd.DataFrame.from_records) come from the real pandas class
        return getattr(cls._real, name)


class _DFMeta(_XMeta):
    _real = _pd.DataFrame


class _SeriesMeta(_XMeta):
    _real = _pd.Series


class XDataFrame(_ProxyBase, metaclass=_DFMeta):
    @property
    def __class__(self):
        # isinstance(proxy, real pd.DataFrame) passes through the
        # __class__ fallback (fast_slow_proxy.py:563)
        return _pd.DataFrame

    _ingest = staticmethod(lambda slow: _FastDF.from_pandas(slow, device=_device()))

    def __init__(self, *args, **kwargs):
        # exact pandas construction; the device ingest is lazy
        a, k = _slow_args(args, kwargs)
        self._slow = _pd.DataFrame(*a, **k)
        self._fast = _UNSET

    def __getitem__(self, key):
        fast = self._fast_obj()
        if fast is not None:
            try:
                k = _unproxy_fast(key) if isinstance(key, _ProxyBase) else key
                return self._rewrap_fast(fast[k])
            except Exception as e:
                if not _replayable(e):
                    raise
                _record_fallback("__getitem__")
        return self._rewrap(self._to_slow()[_unproxy_slow(key)])

    def __setitem__(self, key, value):
        fast = self._fast_obj()
        if fast is not None:
            try:
                fast[key] = _unproxy_fast(value)
                self._slow = None
                return
            except Exception as e:
                if not _replayable(e):
                    raise
                _record_fallback("__setitem__")
        slow = self._to_slow()
        slow[key] = _unproxy_slow(value)
        self._fast = None
        self._slow = slow

    def to_pandas(self):
        return self._to_slow()


class XSeries(_ProxyBase, metaclass=_SeriesMeta):
    @property
    def __class__(self):
        return _pd.Series

    _ingest = staticmethod(lambda slow: _FastSeries(slow, device=_device()))

    def __init__(self, *args, **kwargs):
        a, k = _slow_args(args, kwargs)
        self._slow = _pd.Series(*a, **k)
        self._fast = _UNSET

    def _binop(self, other, op):
        fast = self._fast_obj()
        if fast is not None:
            try:
                return self._rewrap_fast(getattr(fast, op)(_unproxy_fast(other)))
            except Exception as e:
                if not _replayable(e):
                    raise
                _record_fallback(op)
        return self._rewrap(getattr(self._to_slow(), op)(_unproxy_slow(other)))

    def __add__(self, o):
        return self._binop(o, "__add__")

    def __sub__(self, o):
        return self._binop(o, "__sub__")

    def __mul__(self, o):
        return self._binop(o, "__mul__")

    def __truediv__(self, o):
        return self._binop(o, "__truediv__")

    def __gt__(self, o):
        return self._binop(o, "__gt__")

    def __lt__(self, o):
        return self._binop(o, "__lt__")

    def __ge__(self, o):
        return self._binop(o, "__ge__")

    def __le__(self, o):
        return self._binop(o, "__le__")

    def __eq__(self, o):  # type: ignore[override]
        return self._binop(o, "__eq__")

    def __hash__(self):
        raise TypeError("unhashable")

    def __getitem__(self, key):
        # label and boolean indexing keep pandas' corner cases: replay
        return self._rewrap(self._to_slow()[_unproxy_slow(key)])

    def __setitem__(self, key, value):
        slow = self._to_slow()
        slow[_unproxy_slow(key)] = _unproxy_slow(value)
        self._fast = None
        self._slow = slow

    def __contains__(self, key):
        return key in self._to_slow()

    def __iter__(self):
        return iter(self._to_slow())

    def __float__(self):
        return float(self._to_slow())

    def __int__(self):
        return int(self._to_slow())

    def __bool__(self):
        return bool(self._to_slow())


class XIndex:
    """Proxy for the fast Index types: the fast engine's attribute, else
    the equivalent real pandas Index's."""

    def __init__(self, fast):
        self._fast = fast
        self._slow = None

    def _to_slow(self):
        if self._slow is None:
            self._slow = self._fast.to_pandas()
        return self._slow

    def __getattr__(self, name):
        if _pandas_internal_caller():
            return getattr(self._to_slow(), name)
        if hasattr(self._fast, name):
            return getattr(self._fast, name)
        _record_fallback(f"index.{name}")
        return getattr(self._to_slow(), name)

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self._to_slow())
        return out.astype(dtype) if dtype is not None else out

    def __len__(self):
        return len(self._fast)

    def __repr__(self):
        return repr(self._to_slow())

    def __getitem__(self, key):
        return self._to_slow()[_unproxy_slow(key)]

    def __iter__(self):
        return iter(self._to_slow())

    def __contains__(self, key):
        return key in self._to_slow()

    def __eq__(self, other):
        return self._to_slow() == _unproxy_slow(other)

    def __hash__(self):  # a pandas Index is unhashable too
        raise TypeError("unhashable type: 'Index'")


class _GroupByProxy:
    def __init__(self, gb, parent):
        self._gb = gb
        self._parent = parent

    def _slow_gb(self):
        gb = self._gb
        slow = self._parent._to_slow().groupby(gb._keys, as_index=gb._as_index,
                                               sort=gb._sort, dropna=gb._dropna)
        if gb._value_cols is not None:
            # a scalar selection replays as a SeriesGroupBy, a list as a frame
            if gb._scalar_sel and len(gb._value_cols) == 1:
                slow = slow[gb._value_cols[0]]
            else:
                slow = slow[gb._value_cols]
        return slow

    def __getattr__(self, name):
        if hasattr(self._gb, name):
            attr = getattr(self._gb, name)
            if callable(attr):
                def method(*a, **k):
                    try:
                        out = attr(*[_unproxy_fast(x) for x in a],
                                   **{kk: _unproxy_fast(v) for kk, v in k.items()})
                        return self._parent._rewrap_fast(out)
                    except Exception as e:
                        if not _replayable(e):
                            raise
                        _record_fallback(f"groupby.{name}")
                        return self._fallback(name, *a, **k)

                return method
            return self._parent._rewrap_fast(attr)
        # an unknown attribute (g.A, exotic methods): the real groupby's
        _record_fallback(f"groupby.{name}")
        attr = getattr(self._slow_gb(), name)
        if callable(attr) and not isinstance(attr, type):
            def slow_method(*a, **k):
                sa, sk = _slow_args(a, k)
                return self._parent._rewrap(attr(*sa, **sk))

            return slow_method
        return self._parent._rewrap(attr)

    def __getitem__(self, cols):
        return _GroupByProxy(self._gb[cols], self._parent)

    def __iter__(self):
        for key, grp in self._slow_gb():
            yield key, _wrap(grp)

    def _fallback(self, name, *a, **k):
        sa, sk = _slow_args(a, k)
        return self._parent._rewrap(getattr(self._slow_gb(), name)(*sa, **sk))


def _accel_concat(objs, **kw):
    objs = list(objs)
    fasts = [o._fast_obj() if isinstance(o, _ProxyBase) else None for o in objs]
    if all(f is not None for f in fasts) and not kw:
        try:
            return XDataFrame._from_fast(_fast_concat(fasts))
        except Exception as e:
            if not _replayable(e):
                raise
            _record_fallback("concat")
    return _wrap(_pd.concat([_unproxy_slow(o) for o in objs], **kw))


def _accel_merge(left, right, *args, **kw):
    """``pandas.merge(left, right, **kw)`` is ``left.merge(right, **kw)``:
    the proxy's merge, which runs on the engine (the reference leaves the
    top-level merge to pandas). Positional options replay on pandas: the
    engine's merge orders its parameters otherwise."""
    if args:
        _record_fallback("merge")
        return _wrap(_pd.merge(_unproxy_slow(left), _unproxy_slow(right), *args,
                               **{k: _unproxy_slow(v) for k, v in kw.items()}))
    return _wrap(left).merge(_wrap(right), **kw)


def _fast_overrides() -> dict:
    from . import read_csv as _rc, read_json as _rj, read_parquet as _rp

    return {
        "DataFrame": XDataFrame,
        "Series": XSeries,
        "concat": _accel_concat,
        "merge": _accel_merge,
        "read_parquet": lambda p, **kw: XDataFrame._from_fast(_rp(p, device=_device(), **kw)),
        "read_csv": lambda p, **kw: XDataFrame._from_fast(_rc(p, device=_device(), **kw)),
        "read_json": lambda p, **kw: XDataFrame._from_fast(_rj(p, device=_device(), **kw)),
    }


class _AccelModule(types.ModuleType):
    """Caller-sensitive pandas facade (module_accelerator.py:366 analog):
    pandas' own code (submodules doing ``from pandas import DataFrame``,
    accessors constructing a Series) sees the real types, user code the
    proxies. Resolution reads the calling module's ``__name__``."""

    def __getattribute__(self, name):
        over = types.ModuleType.__getattribute__(self, "_overrides")
        if name in over:
            try:
                caller = sys._getframe(1).f_globals.get("__name__", "")
            except ValueError:  # no caller frame (C API)
                caller = ""
            if (caller == "pandas" or caller.startswith("pandas.")) and \
                    not caller.startswith("pandas.tests"):
                return getattr(_pd, name)
            return over[name]
        return types.ModuleType.__getattribute__(self, name)


def _make_module() -> types.ModuleType:
    m = _AccelModule("pandas")
    m.__cudf_tpu_accel__ = True
    m._cudf_real_pandas = _pd  # what utils/real_pandas.py unwraps
    # the real package's __path__, so that `import pandas.anything` loads the
    # genuine submodules (they bind to the real pandas)
    m.__path__ = list(getattr(_pd, "__path__", []))
    m._overrides = _fast_overrides()
    for name in dir(_pd):  # everything else: real pandas
        if not hasattr(m, name):
            try:
                setattr(m, name, getattr(_pd, name))
            except (AttributeError, ImportError):  # a lazy attribute that fails to load
                pass
    return m


class _AccelFinder:
    """Meta-path finder: ``import pandas`` resolves to the proxy module even
    when installed before pandas is first imported
    (cudf.pandas.module_accelerator.ModuleAccelerator:366). Submodule
    imports flow through the proxy's ``__path__`` to the real files."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != "pandas":
            return None
        import importlib.util

        return importlib.util.spec_from_loader(fullname, _AccelLoader())


class _AccelLoader:
    def create_module(self, spec):
        return _make_module()

    def exec_module(self, module):
        pass


_finder = _AccelFinder()


def install(device=None) -> types.ModuleType:
    """Replace ``pandas`` with the accelerated proxy module (cudf.pandas
    ``install()``): patches sys.modules for code already imported and
    registers a meta-path finder for later imports. Every ingest goes to
    ``device``; None means CUDA, and raises here when there is no card."""
    global _DEVICE
    _DEVICE = resolve_device(device)
    return install_hook()


def install_hook() -> types.ModuleType:
    """``install`` without choosing a device, as ``python -m
    cudf_tpu_torch.pandas`` installs: each ingest resolves CUDA (and
    raises without a card) unless the script calls ``install(device=...)``."""
    m = _make_module()
    sys.modules["pandas"] = m
    if _finder not in sys.meta_path:
        sys.meta_path.insert(0, _finder)
    return m


def uninstall() -> None:
    """Restore the real pandas module."""
    global _DEVICE
    if _finder in sys.meta_path:
        sys.meta_path.remove(_finder)
    sys.modules["pandas"] = _pd
    _DEVICE = None


# module-level convenience: `import cudf_tpu_torch.pandas_accel as xpd`
DataFrame = XDataFrame
Series = XSeries
_mod = None


def __getattr__(name):
    global _mod
    if _mod is None:
        _mod = _make_module()
    return getattr(_mod, name)
