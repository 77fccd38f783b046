"""Expression DSL evaluated against Tables (counterpart of
``cudf_tpu/expr/expressions.py``).

Analog of cudf-polars' expression nodes (reference: python/cudf_polars/
cudf_polars/dsl/expressions/ — Col base.py:134, BinOp binaryop.py:26, Agg
aggregation.py:28, StringFunction string.py:58, TemporalFunction
datetime.py:40, Ternary ternary.py:27, Cast/UnaryFunction unary.py:23-74).
Every node evaluates eagerly to a chain of torch column ops.

The node classes and their sugar are the reference's. Evaluation differs
in one way: a ``Literal`` under a ``BinOp`` stays a scalar, and
``binary_op`` broadcasts it as a 0-d tensor, where the reference first
builds a full-length column (at 60M rows, ``1 - col("l_discount")`` would
allocate and read a 480 MB constant). Anywhere else a literal becomes a
full-length column, as in the reference; the answers are equal. String
functions run through ``ops/strings.py`` and temporal ones through
``ops/datetime.py``, whose ``extract`` gives pandas' ``day_of_year`` and
``truncate`` pandas' month and year starts where the reference's do not
(ROADMAP section 3).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import dtypes
from ..core.column import Column
from ..core.table import Table
from ..ops import binaryop, copying, unaryop
from ..ops import datetime as dt_ops
from ..ops import strings as str_ops
from .nodebase import CachingVisitor, Node


class Expr(Node):
    """Base expression node."""

    # -- sugar ---------------------------------------------------------------
    def _bin(self, other, op):
        return BinOp(op, children=(self, _wrap(other)))

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return _wrap(o)._bin(self, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return _wrap(o)._bin(self, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return _wrap(o)._bin(self, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return _wrap(o)._bin(self, "div")

    def __mod__(self, o):
        return self._bin(o, "mod")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, "eq")

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(o, "ne")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __le__(self, o):
        return self._bin(o, "le")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __ge__(self, o):
        return self._bin(o, "ge")

    def __and__(self, o):
        return self._bin(o, "and")

    def __or__(self, o):
        return self._bin(o, "or")

    def __invert__(self):
        return UnaryFn("not", children=(self,))

    def __neg__(self):
        return UnaryFn("neg", children=(self,))

    def __hash__(self):
        return Node.__hash__(self)

    def alias(self, name: str) -> "NamedExpr":
        return NamedExpr(name, self)

    def cast(self, to) -> "Cast":
        return Cast(to, children=(self,))

    def is_null(self):
        return UnaryFn("is_null", children=(self,))

    def is_not_null(self):
        return UnaryFn("is_valid", children=(self,))

    def is_nan(self):
        return UnaryFn("is_nan", children=(self,))

    def fill_null(self, value):
        return FillNull(value, children=(self,))

    def abs(self):
        return UnaryFn("abs", children=(self,))

    def is_in(self, values) -> "IsIn":
        return IsIn(tuple(values), children=(self,))

    def between(self, lo, hi, inclusive: bool = True):
        if inclusive:
            return (self >= lo) & (self <= hi)
        return (self > lo) & (self < hi)

    # aggregations (usable in groupby/select contexts)
    def sum(self):
        return Agg("sum", children=(self,))

    def mean(self):
        return Agg("mean", children=(self,))

    def min(self):
        return Agg("min", children=(self,))

    def max(self):
        return Agg("max", children=(self,))

    def count(self):
        return Agg("count", children=(self,))

    def nunique(self):
        return Agg("nunique", children=(self,))

    def var(self, ddof=1):
        return Agg("var", ddof, children=(self,))

    def std(self, ddof=1):
        return Agg("std", ddof, children=(self,))

    def median(self):
        return Agg("median", children=(self,))

    def quantile(self, q):
        return Agg("quantile", q, children=(self,))

    def first(self):
        return Agg("first", children=(self,))

    def last(self):
        return Agg("last", children=(self,))

    @property
    def str(self):
        return _StrNS(self)

    @property
    def dt(self):
        return _DtNS(self)


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


class Col(Expr):
    def __init__(self, name: str, children=()):
        super().__init__(name)

    @property
    def name(self):
        return self.args[0]


class Literal(Expr):
    def __init__(self, value, children=()):
        if isinstance(value, np.generic) and not isinstance(
            value, (np.datetime64, np.timedelta64)
        ):
            value = value.item()
        super().__init__(value)

    @property
    def value(self):
        return self.args[0]


class BinOp(Expr):
    def __init__(self, op: str, children=()):
        super().__init__(op, children=children)

    @property
    def op(self):
        return self.args[0]


class UnaryFn(Expr):
    def __init__(self, fn: str, children=()):
        super().__init__(fn, children=children)


class Cast(Expr):
    def __init__(self, to, children=()):
        super().__init__(to, children=children)


class FillNull(Expr):
    def __init__(self, value, children=()):
        super().__init__(value, children=children)


class IsIn(Expr):
    def __init__(self, values: tuple, children=()):
        super().__init__(values, children=children)


class Ternary(Expr):
    """when(cond).then(a).otherwise(b)"""

    def __init__(self, children=()):
        super().__init__(children=children)


class Agg(Expr):
    def __init__(self, kind: str, param: float = 0.0, children=()):
        super().__init__(kind, param, children=children)

    @property
    def kind(self):
        return self.args[0]

    @property
    def param(self):
        return self.args[1]


class Len(Expr):
    """Row count (polars pl.len())."""

    def __init__(self, children=()):
        super().__init__()


class StringFn(Expr):
    def __init__(self, fn: str, params: tuple = (), children=()):
        super().__init__(fn, params, children=children)


class TemporalFn(Expr):
    def __init__(self, fn: str, params: tuple = (), children=()):
        super().__init__(fn, params, children=children)


class SortedIndices(Expr):
    """argsort of child (for Gather-style exprs)."""

    def __init__(self, descending=False, children=()):
        super().__init__(descending, children=children)


class NamedExpr:
    """(name, expr) pair — not a dag node (reference base.py NamedExpr)."""

    __slots__ = ("name", "expr")

    def __init__(self, name: str, expr: Expr):
        self.name = name
        self.expr = expr

    def __repr__(self):  # pragma: no cover
        return f"{self.expr!r}.alias({self.name!r})"


class _StrNS:
    def __init__(self, e: Expr):
        self._e = e

    def contains(self, pat, regex=True):
        return StringFn("contains", (pat, regex), children=(self._e,))

    def startswith(self, pat):
        return StringFn("startswith", (pat,), children=(self._e,))

    def endswith(self, pat):
        return StringFn("endswith", (pat,), children=(self._e,))

    def like(self, pattern):
        return StringFn("like", (pattern,), children=(self._e,))

    def lower(self):
        return StringFn("lower", (), children=(self._e,))

    def upper(self):
        return StringFn("upper", (), children=(self._e,))

    def strip(self):
        return StringFn("strip", (), children=(self._e,))

    def slice(self, start, stop=None):
        return StringFn("slice", (start, stop), children=(self._e,))

    def len(self):
        return StringFn("len", (), children=(self._e,))


class _DtNS:
    def __init__(self, e: Expr):
        self._e = e

    def __getattr__(self, field):
        if field in ("year", "month", "day", "weekday", "hour", "minute",
                     "second", "day_of_year"):
            return lambda: TemporalFn("extract", (field,), children=(self._e,))
        raise AttributeError(field)

    def truncate(self, freq):
        return TemporalFn("truncate", (freq,), children=(self._e,))


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Literal:
    return Literal(value)


def when(cond: Expr):
    class _When:
        def __init__(self, c):
            self.c = c

        def then(self, a):
            c = self.c

            class _Then:
                def otherwise(self, b):
                    return Ternary(children=(c, _wrap(a), _wrap(b)))

            return _Then()

    return _When(cond)




# ---------------------------------------------------------------------------
class _Lit:
    """A literal's value while it is still a scalar."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _device(tbl: Table) -> torch.device:
    """Where a literal's column goes: the table's device, read without
    decoding a deferred column."""
    dev = tbl.device
    if dev is not None:
        return dev
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def evaluate(expr: Expr, tbl: Table) -> Column:
    """Evaluate an expression against a table, returning a Column."""

    def column(x: Any) -> Column:
        if isinstance(x, _Lit):
            return Column.from_scalar(x.value, max(tbl.num_rows, 0), device=_device(tbl))
        return x

    def _eval(node: Expr, visitor):
        if isinstance(node, Col):
            return tbl[node.name]
        if isinstance(node, Literal):
            return _Lit(node.value)
        if isinstance(node, BinOp):
            l = visitor(node.children[0])
            r = visitor(node.children[1])
            if isinstance(l, _Lit) and isinstance(r, _Lit):
                l = column(l)
            return binaryop.binary_op(l.value if isinstance(l, _Lit) else l,
                                      r.value if isinstance(r, _Lit) else r, node.op)

        def child(i=0) -> Column:
            return column(visitor(node.children[i]))

        if isinstance(node, UnaryFn):
            c = child()
            fn = node.args[0]
            if fn == "is_null":
                return unaryop.is_null(c)
            if fn == "is_valid":
                return unaryop.is_valid(c)
            if fn == "is_nan":
                return unaryop.is_nan(c)
            return unaryop.unary_op(c, fn)
        if isinstance(node, Cast):
            return unaryop.cast(child(), node.args[0])
        if isinstance(node, FillNull):
            return unaryop.replace_nulls(child(), node.args[0])
        if isinstance(node, IsIn):
            c = child()
            out = None
            for v in node.args[0]:
                m = binaryop.binary_op(c, v, "eq")
                out = m if out is None else binaryop.binary_op(out, m, "or")
            if out is None:
                return Column.from_scalar(False, c.length, device=c.device)
            return out
        if isinstance(node, Ternary):
            return _where(child(0), child(1), child(2))
        if isinstance(node, StringFn):
            return _string_fn(child(), node.args[0], node.args[1])
        if isinstance(node, TemporalFn):
            c = child()
            fn, params = node.args
            if fn == "extract":
                return dt_ops.extract(c, params[0])
            if fn == "truncate":
                return dt_ops.truncate(c, params[0])
            raise ValueError(f"temporal fn {fn}")
        if isinstance(node, Len):
            return Column.from_scalar(tbl.num_rows, 1, dtypes.int64, device=_device(tbl))
        if isinstance(node, Agg):
            return _full_column_agg(child(), node.kind, node.param)
        raise TypeError(f"cannot evaluate {type(node).__name__}")

    return column(CachingVisitor(_eval)(expr))


def _string_fn(c: Column, fn: str, params: tuple) -> Column:
    if fn == "contains":
        return str_ops.contains(c, params[0], regex=params[1])
    if fn == "startswith":
        return str_ops.startswith(c, params[0])
    if fn == "endswith":
        return str_ops.endswith(c, params[0])
    if fn == "like":
        return str_ops.match_like(c, params[0])
    if fn == "lower":
        return str_ops.lower(c)
    if fn == "upper":
        return str_ops.upper(c)
    if fn == "strip":
        return str_ops.strip(c)
    if fn == "slice":
        return str_ops.slice_strings(c, params[0], params[1])
    if fn == "len":
        return str_ops.len_strings(c)
    raise ValueError(f"string fn {fn}")


def _where(cond: Column, a: Column, b: Column) -> Column:
    """Elementwise select in the two sides' common dtype, with null
    propagation from the chosen side; a null condition takes ``b``."""
    if a.dtype != b.dtype and not (a.dtype.is_string or b.dtype.is_string):
        common = dtypes.common_dtype(a.dtype, b.dtype)
        a, b = unaryop.cast(a, common), unaryop.cast(b, common)
    return copying.copy_if_else(a, b, cond)


def _full_column_agg(c: Column, kind: str, param) -> Column:
    """Whole-column reduction (ops/reductions)."""
    from ..ops.reductions import reduce as reduce_op

    return reduce_op(c, kind, param)
