"""join_rebuild_share: the host time of every ``hash_build.round`` range
but the last inside its ``hash_build`` range (``ops/fastjoin.py:
build_hash_table``: a round is one table size, which ends in a host read,
so its host time is its time), in % of the traced window: the builds
thrown away for a row that found no slot. A build's last round is the
one kept, or the one whose build the join then refused; it is not
counted."""
from portbench.harness import spans as sp
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    builds = tr.outermost(ctx.trace, "hash_build")
    if not builds:
        return None
    rounds = sp.inside(ctx.trace, builds, "hash_build.round")
    redone = sum(e - s for r in rounds for s, e in r[:-1])
    return 100 * redone / (ctx.trace.window[1] - ctx.trace.window[0])
