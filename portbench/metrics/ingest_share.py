"""ingest_share: the summed host time of the benchmark's own
``portbench.from_pandas`` spans (closed by a synchronize), in % of the
traced window. The program has no range around ``from_pandas`` yet."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    return tr.range_share(ctx.trace, "portbench.from_pandas")
