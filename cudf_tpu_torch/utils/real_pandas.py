"""The genuine pandas module, never the accelerator's proxy.

Counterpart of ``cudf_tpu/utils/real_pandas.py``. The port's internals
must not construct through the proxy that ``pandas_accel.install()`` puts
in ``sys.modules["pandas"]`` (that would recurse proxy -> fast -> proxy).
``cudf_tpu_torch/__init__.py`` imports this module first, before any
install can run; if the port's proxy is installed already, it is unwrapped.
"""
import pandas as _maybe_proxy

pd = getattr(_maybe_proxy, "_cudf_real_pandas", _maybe_proxy)

pandas = pd
