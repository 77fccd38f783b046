"""The one generator of traffic: a mix is a data file, read here.

``traffic/<mix>.json`` holds

- ``operations``: ``{name: weight}``, names of the configuration's
  operations; a block holds each operation ``weight`` times;
- ``trace_blocks``: how many blocks a traced run records.

Each block is a permutation drawn from the seed, so every seed runs the
same work in another order, and a window of any length holds each
operation in its share but for the last, partial block.
"""
from __future__ import annotations

import numpy as np


def block(mix: dict) -> list:
    """One block's operations, in the file's order."""
    return [op for op, w in mix["operations"].items() for _ in range(int(w))]


def sequence(mix: dict, seed: int):
    """The operations of a run, block after block, without end."""
    ops = block(mix)
    rng = np.random.default_rng(seed)
    while True:
        for i in rng.permutation(len(ops)):
            yield ops[i]
