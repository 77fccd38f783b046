"""TPC-H Q1 through the DataFrame API: the same answer as the IR's q1,
worked out by ``reference.tpch_sf30.q1``."""
from __future__ import annotations

from portbench.reference.tpch_sf30 import q1


def answers(raw: dict, spec: dict, instances, dtype) -> dict:
    """{(operation, parameters): (answer, counts)} for each instance."""
    return {(op, params): q1(raw, dtype, *params) for op, params in set(instances)}
