"""GET_JSON_PATH: JSONPath extraction on string columns (counterpart of
``cudf_tpu/ops/json_ops.py``).

Analog of cpp/src/json/ (the get_json_object device kernel). String columns
are dictionary-encoded, so the path is evaluated once per distinct value on
the host and the result comes back to the rows through one device gather
of the codes; the device never parses bytes. The JSONPath subset is the
reference's (cpp/src/json/json_path.cu): ``$``, ``.child``, ``['child']``,
``[index]``, ``[*]``/``.*`` wildcards.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ..core.column import Column
from .strings import _dict_values, _remap_with_nulls


def _parse_path(path: str) -> List:
    """Tokenize a JSONPath into field / index / wildcard steps."""
    if not path.startswith("$"):
        raise ValueError("JSONPath must start with $")
    i, steps = 1, []
    while i < len(path):
        c = path[i]
        if c == ".":
            i += 1
            if i < len(path) and path[i] == "*":
                steps.append(("wild",))
                i += 1
                continue
            j = i
            while j < len(path) and path[j] not in ".[":
                j += 1
            steps.append(("field", path[i:j]))
            i = j
        elif c == "[":
            j = path.index("]", i)
            inner = path[i + 1 : j].strip()
            if inner == "*":
                steps.append(("wild",))
            elif inner[:1] in ("'", '"'):
                steps.append(("field", inner[1:-1]))
            else:
                steps.append(("index", int(inner)))
            i = j + 1
        else:
            raise ValueError(f"bad JSONPath at {path[i:]!r}")
    return steps


def _walk(node, steps):
    """Evaluate steps against a parsed JSON node; list results on wildcard."""
    cur = [node]
    for step in steps:
        nxt = []
        for n in cur:
            if step[0] == "field":
                if isinstance(n, dict) and step[1] in n:
                    nxt.append(n[step[1]])
            elif step[0] == "index":
                if isinstance(n, list) and -len(n) <= step[1] < len(n):
                    nxt.append(n[step[1]])
            else:  # wildcard
                if isinstance(n, list):
                    nxt.extend(n)
                elif isinstance(n, dict):
                    nxt.extend(n.values())
        cur = nxt
    return cur


def _render(matches) -> Optional[str]:
    """Reference semantics: scalar → bare string; object/array → raw JSON;
    multiple matches → JSON array; none → null."""
    if not matches:
        return None
    if len(matches) == 1:
        m = matches[0]
        if isinstance(m, str):
            return m
        if isinstance(m, bool):
            return "true" if m else "false"
        if m is None:
            return "null"
        if isinstance(m, (int, float)):
            return json.dumps(m)
        return json.dumps(m, separators=(",", ":"))
    return json.dumps(matches, separators=(",", ":"))


def get_json_path(col: Column, path: str) -> Column:
    """Extract a JSONPath from every row of a JSON string column; invalid
    JSON or no match gives null."""
    if not col.dtype.is_string:
        raise TypeError("get_json_path requires a string column")
    steps = _parse_path(path)
    out_vals: List[Optional[str]] = []
    for s in _dict_values(col):
        try:
            out_vals.append(_render(_walk(json.loads(s), steps)))
        except (json.JSONDecodeError, ValueError):
            out_vals.append(None)
    matched = np.array([v is not None for v in out_vals], bool)
    return _remap_with_nulls(col, np.array(out_vals, dtype=object), matched)
