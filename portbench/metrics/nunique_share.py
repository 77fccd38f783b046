"""nunique_share: the device time of the operations launched inside the
outermost ``groupby.nunique`` ranges (``ops/groupby.py``'s per-group
distinct count: the (keys, value) sort and the count of value runs), in %
of the traced window. None where the trace holds no such range (a program
without it) or no device operation (a run on the CPU)."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    spans = tr.outermost(ctx.trace, "groupby.nunique")
    if not spans:
        return None
    return 100 * tr.device_s_launched_in(ctx.trace, spans) / ctx.trace.window_s
