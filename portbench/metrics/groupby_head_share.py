"""groupby_head_share: the summed host time of the outermost
``groupby_head`` ranges (``frame/groupby.py:DataFrameGroupBy.head``: the
grouped row number and the compaction, which waits for its output size),
in % of the traced window."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    return tr.range_share(ctx.trace, "groupby_head")
