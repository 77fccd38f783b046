"""join_share: the summed host time of the outermost ``join`` ranges
(the program's ``trace_op`` on ``ops.join.join``), in % of the traced
window."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    return tr.range_share(ctx.trace, "join")
