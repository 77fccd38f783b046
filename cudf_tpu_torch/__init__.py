"""cudf_tpu_torch: the PyTorch/CUDA port of cudf_tpu.

Same module layout and names as ``cudf_tpu``, on torch tensors with an
explicit device. Ingest entry points default to ``device="cuda"`` and
raise when CUDA is missing; operators run on the device of their inputs.
This package imports neither jax nor anything of ``cudf_tpu``.

Ported so far: the columnar core with categorical columns
(``core/categorical.py``), stats and row codes, the sort primitive,
gather and concatenate, null/mask compaction and ``distinct``,
groupby-aggregate with its one-hot, code-sort and generic lanes
(``ops/groupby.py``), the unary and binary ops, reductions and scans,
sorting, search and merge, equi-joins with the hash-table lane for
distinct build sides and the general sort lane (``ops/join.py``), the
expression/IR executor (``expr/``), which runs TPC-H q1, q3, q5 and q6,
the string, regex, text, JSON and datetime ops (``ops/strings.py``,
``ops/regex_dfa.py``, ``ops/text.py``, ``ops/json_ops.py``,
``ops/datetime.py``), filling, dictionary encoding, murmur3 hashing,
rolling and grouped windows (``ops/filling.py``, ``ops/dictionary.py``,
``ops/hashing.py``, ``ops/rolling.py``, ``ops/grouped_window.py``), Arrow
and DLPack interop (``core/interop.py``), the pyarrow readers and writers
with deferred column decode (``io/``), the pandas-like DataFrame API
(``frame/``) and out-of-core execution: the device-memory budget and the
host partition store (``utils/hbm.py``, ``utils/native.py``), chunked
sorts, groupbys and compactions (``ops/chunked.py``,
``ops/streaming_groupby.py``), row-group pruning and the chunked parquet
reader (``io/parquet_ext.py``, ``io/datasource.py``), spilled partitions
(``parallel/partitioned.py``) and the partitioned plan executor
(``expr/lowering.py``, ``parallel/plan_executor.py``), and the nested
types and long tail: list, struct and interval columns
(``core/lists.py``, ``core/structs.py``, ``core/interval.py``), the list
ops, conditional and mixed joins (``ops/list_ops.py``, ``ops/join.py``),
t-digest and HLL sketches, bloom filters, md5/sha/xxhash row hashes and
pack (``ops/tdigest.py``, ``ops/bloom.py``, ``ops/crypto_hash.py``,
``ops/pack.py``), avro and ``s3://`` sources (``io/avro.py``,
``io/s3.py``), decimal32/64/128 columns (``ops/decimal.py``,
``ops/decimal128.py``), and the pandas accelerator (``pandas_accel.py``,
``python -m cudf_tpu_torch.pandas``) with the options registry, tracing
and prewarm (``utils/options.py``, ``utils/tracing.py``,
``utils/prewarm.py``), reached by module as in the reference.

The top level is the reference's: ``read_parquet``, ``read_csv``,
``read_json`` and ``read_orc`` return a ``DataFrame`` (``io.read_*``
return a ``Table``), ``from_pandas`` takes a pandas DataFrame or Series,
and ``concat`` joins frames or Series. Each takes ``device=``.
"""
from .utils import real_pandas as _real_pandas  # noqa: F401  (real pandas, before any install)
from . import io
from .core import dtypes, interop  # noqa: F401
from .core.column import Column  # noqa: F401
from .core.table import Table  # noqa: F401
from .frame import DataFrame, Series, concat  # noqa: F401
from .ops.binaryop import binary_op  # noqa: F401
from .ops.groupby import AggSpec, groupby_aggregate  # noqa: F401
from .ops.join import cross_join, join  # noqa: F401
from .ops.stream_compaction import apply_boolean_mask, distinct, drop_nulls  # noqa: F401


def read_parquet(path, columns=None, filters=None, predicates=None,
                 device=None) -> DataFrame:
    """A DataFrame over ``io.read_parquet``'s table: one file's columns
    stay deferred until an op reads them."""
    return DataFrame._from_table(io.read_parquet(path, columns, filters, predicates,
                                                  device=device))


def read_csv(path, device=None, **kw) -> DataFrame:
    return DataFrame._from_table(io.read_csv(path, device=device, **kw))


def read_json(path, lines=True, device=None, **kw) -> DataFrame:
    return DataFrame._from_table(io.read_json(path, lines=lines, device=device, **kw))


def read_orc(path, columns=None, device=None) -> DataFrame:
    return DataFrame._from_table(io.read_orc(path, columns, device=device))


def prewarm(n_rows, background: bool = True, device=None):
    """Build the CUDA kernels and warm the sort and scans for the capacity
    buckets of ``n_rows`` (``utils/prewarm.py``); a background thread by
    default, whose ``join`` raises what the warm-up raised."""
    from .utils.prewarm import prewarm as _pw

    return _pw(n_rows, background, device=device)


def from_pandas(obj, device=None):
    """A pandas DataFrame as a DataFrame, anything else as a Series."""
    from .utils.real_pandas import pd

    if isinstance(obj, pd.DataFrame):
        return DataFrame.from_pandas(obj, device=device)
    return Series(obj, device=device)


__all__ = ["Column", "Table", "DataFrame", "Series", "concat", "from_pandas",
           "AggSpec", "groupby_aggregate", "drop_nulls", "apply_boolean_mask",
           "distinct", "binary_op", "join", "cross_join", "dtypes", "interop", "io",
           "read_parquet", "read_csv", "read_json", "read_orc", "prewarm"]
