"""join_host_reads: the ``host_read.*`` ranges (each statement of the join
that waits for the card to hand the host a value: ``ops/join.py``,
``ops/fastjoin.py``, ``kernels/hashtable.py:build_table``) inside the
outermost ``join`` ranges, over the number of those ranges: the host's
waits a join."""
from portbench.harness import spans as sp
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    joins = tr.outermost(ctx.trace, "join")
    if not joins:
        return None
    reads = sum(map(len, sp.inside(ctx.trace, joins, lambda n: n.startswith("host_read."))))
    return reads / len(joins) if reads else None  # none: a program without the ranges
