"""groupby_generic_share: the summed host time of the outermost
``groupby.generic`` ranges (``ops/groupby.py:aggregate_in_memory``'s call
of the generic engine, the lane that answers what the sort and wide lanes
refuse: median, quantile, nunique), in % of the traced window. The range
ends when the engine has launched its reductions, not when the card has
run them: the device work it leaves behind shows in the next host read
(``to_pandas``), so this share is the engine's host time and no more."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    return tr.range_share(ctx.trace, "groupby.generic")
