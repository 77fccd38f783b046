"""cudf_tpu_torch: the PyTorch/CUDA port of cudf_tpu.

Same module layout and names as ``cudf_tpu``, on torch tensors with an
explicit device. Ingest entry points default to ``device="cuda"`` and
raise when CUDA is missing; operators run on the device of their inputs.
This package imports neither jax nor anything of ``cudf_tpu``.

Ported so far: the columnar core, stats and row codes, the sort primitive,
gather and concatenate, null/mask compaction and ``distinct``,
groupby-aggregate with its one-hot, code-sort and generic lanes
(``ops/groupby.py``), the unary and binary ops, reductions and scans,
sorting, search and merge, equi-joins with the hash-table lane for
distinct build sides and the general sort lane (``ops/join.py``), and the
expression/IR executor (``expr/``), which runs TPC-H q1, q3, q5 and q6.
"""
from .core import dtypes  # noqa: F401
from .core.column import Column  # noqa: F401
from .core.table import Table  # noqa: F401
from .ops.binaryop import binary_op  # noqa: F401
from .ops.groupby import AggSpec, groupby_aggregate  # noqa: F401
from .ops.join import cross_join, join  # noqa: F401
from .ops.stream_compaction import apply_boolean_mask, distinct, drop_nulls  # noqa: F401

__all__ = ["Column", "Table", "AggSpec", "groupby_aggregate", "drop_nulls",
           "apply_boolean_mask", "distinct", "binary_op", "join", "cross_join",
           "dtypes"]
