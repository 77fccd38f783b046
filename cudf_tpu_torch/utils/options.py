"""Validated options registry with environment-variable defaults.

Counterpart of ``cudf_tpu/utils/options.py`` (python/cudf/cudf/options.py:
15-46, registry and env defaults; the C++ getenv_or helpers,
cpp/src/utilities/getenv_or.cpp), with the reference's option names and
environment variables for the options the port reads.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional


class _Option:
    __slots__ = ("name", "value", "default", "validator", "description")

    def __init__(self, name, default, validator, description):
        self.name = name
        self.default = default
        self.value = default
        self.validator = validator
        self.description = description


_OPTIONS: Dict[str, _Option] = {}


def _register(name: str, default, validator: Callable[[Any], bool],
              description: str, env: Optional[str] = None):
    if env and env in os.environ:
        raw = os.environ[env]
        if isinstance(default, bool):
            default = raw.lower() in ("1", "true", "on", "yes")
        elif isinstance(default, int):
            default = int(raw)
        elif isinstance(default, float):
            default = float(raw)
        else:
            default = raw
    _OPTIONS[name] = _Option(name, default, validator, description)


def get_option(name: str):
    return _OPTIONS[name].value


def set_option(name: str, value):
    opt = _OPTIONS[name]
    if not opt.validator(value):
        raise ValueError(f"invalid value {value!r} for option {name}")
    opt.value = value


def describe_options() -> Dict[str, str]:
    return {n: o.description for n, o in _OPTIONS.items()}


@contextmanager
def option_context(name: str, value):
    old = get_option(name)
    set_option(name, value)
    try:
        yield
    finally:
        set_option(name, old)


def _bool(v) -> bool:
    return isinstance(v, bool)


def _pos_int(v) -> bool:
    return isinstance(v, int) and v > 0


# Only the options some code of the port reads are registered
# (target_partition_rows: parallel/actor_graph.py's chunk rows); the
# reference's others (spill, broadcast_limit_rows, default_float_bitwidth,
# shuffle_bucket_factor) come with the code that reads them.
_register("performance_tracking", False, _bool,
          "Emit per-op timing logs (utils/tracing.py).",
          env="CUDF_TPU_PERFORMANCE_TRACKING")
_register("target_partition_rows", 4_000_000, _pos_int,
          "Rows per partition for chunked readers (analog of "
          "target_partition_size, utils/config.py:277).",
          env="CUDF_TPU_TARGET_PARTITION_ROWS")
