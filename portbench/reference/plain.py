"""The relational steps that the references share, in plain torch."""
from __future__ import annotations

import torch


def codes(cols: list) -> torch.Tensor:
    """One int64 code a row for a tuple of key columns, in the tuples'
    lexicographic order (each column ranked, the ranks in mixed radix)."""
    code = torch.zeros(len(cols[0]), dtype=torch.int64, device=cols[0].device)
    for c in cols:
        uniq, inv = torch.unique(c, return_inverse=True)
        code = code * len(uniq) + inv
    return code


def lookup(build: list, probe: list) -> torch.Tensor:
    """For each probe row, the build row whose keys equal its keys, or -1.
    The build side's key tuples must be distinct, as every build side of
    these queries is."""
    n_build = len(build[0])
    if n_build == 0:
        return torch.full((len(probe[0]),), -1, dtype=torch.int64, device=probe[0].device)
    both = codes([torch.cat([b, p]) for b, p in zip(build, probe)])
    b_code, p_code = both[:n_build], both[n_build:]
    b_sorted, order = torch.sort(b_code)
    if bool((b_sorted[1:] == b_sorted[:-1]).any()):
        raise ValueError("the build side's keys are not distinct")
    pos = torch.searchsorted(b_sorted, p_code).clamp(max=n_build - 1)
    return torch.where(b_sorted[pos] == p_code, order[pos], -1)


def group(keys: list, values: dict, dtype) -> tuple:
    """(the distinct key tuples in ascending order as a list of columns,
    {name: the sum of values[name] a group, in ``dtype``}, the row count a
    group)."""
    code = codes(keys)
    uniq, inv = torch.unique(code, return_inverse=True)
    first = torch.full((len(uniq),), len(code), dtype=torch.int64, device=code.device)
    first.scatter_reduce_(0, inv, torch.arange(len(code), device=code.device), "amin")
    sums = {n: torch.zeros(len(uniq), dtype=dtype, device=code.device)
            .index_add_(0, inv, v.to(dtype)) for n, v in values.items()}
    counts = torch.bincount(inv, minlength=len(uniq))
    return [k[first] for k in keys], sums, counts
