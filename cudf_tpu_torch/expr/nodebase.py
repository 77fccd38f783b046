"""Hashable DAG node base + traversal utilities (counterpart of
``cudf_tpu/expr/nodebase.py``, which imports no framework and is carried
over as it is).

Reimplementation of the cudf-polars dag machinery (reference:
python/cudf_polars/cudf_polars/dsl/nodebase.py:33, traversal.py:31-172) —
the survey calls this visitor infrastructure "worth reimplementing as-is":
both expression fusion and distributed lowering are built on it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Generator, Tuple


class Node:
    """Immutable, hashable DAG node: identity = (type, *non-child args, children)."""

    __slots__ = ("_hash", "children", "args")

    def __init__(self, *args, children: Tuple["Node", ...] = ()):
        object.__setattr__(self, "args", args)
        object.__setattr__(self, "children", tuple(children))
        object.__setattr__(self, "_hash", None)

    def __setattr__(self, name, value):  # immutability
        if name in ("_hash",):
            object.__setattr__(self, name, value)
            return
        raise AttributeError(f"{type(self).__name__} nodes are immutable")

    def _key(self):
        return (type(self), self.args, self.children)

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(self._key())
        return self._hash

    def __eq__(self, other):
        return type(self) is type(other) and self._key() == other._key()

    def reconstruct(self, children) -> "Node":
        return type(self)(*self.args, children=tuple(children))

    def __repr__(self):  # pragma: no cover
        a = ", ".join(map(repr, self.args))
        c = ", ".join(map(repr, self.children))
        return f"{type(self).__name__}({a}{'; ' if c else ''}{c})"


def traversal(node: Node) -> Generator[Node, None, None]:
    """Pre-order DFS over unique nodes."""
    seen = {node}
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in n.children:
            if c not in seen:
                seen.add(c)
                stack.append(c)


class CachingVisitor:
    """Memoized bottom-up rewriter (reference traversal.py CachingVisitor)."""

    def __init__(self, fn: Callable[["Node", "CachingVisitor"], Any], state=None):
        self.fn = fn
        self.cache: Dict[Node, Any] = {}
        self.state = state or {}

    def __call__(self, node: Node):
        try:
            return self.cache[node]
        except KeyError:
            result = self.fn(node, self)
            self.cache[node] = result
            return result
