"""groupby_share: the summed host time of the outermost
``groupby_aggregate`` ranges (the program's ``trace_op`` on
``ops.groupby.groupby_aggregate``), in % of the traced window."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    return tr.range_share(ctx.trace, "groupby_aggregate")
