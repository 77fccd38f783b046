"""The genuine pandas module (counterpart of ``cudf_tpu/utils/real_pandas.py``).

The reference keeps this alias so that its internals never construct
through its pandas accelerator proxy. The port has no proxy yet, so the
alias is plain pandas; modules import ``pd`` from here so that the proxy,
once ported, has one place to unwrap.
"""
import pandas as pd

pandas = pd
