"""cudf_tpu_torch.pandas: the zero-code-change pandas accelerator's entry.

Counterpart of ``cudf_tpu/pandas/__init__.py`` (cudf.pandas,
python/cudf/cudf/pandas/__init__.py:33): ``import cudf_tpu_torch.pandas;
cudf_tpu_torch.pandas.install()``, or run a script unchanged with
``python -m cudf_tpu_torch.pandas script.py``. Importing it installs
nothing and resolves no device.
"""
from ..pandas_accel import fallback_stats, install, uninstall  # noqa: F401
