"""ingest_host_share: the host time inside the outermost
``Table.from_pandas`` ranges (the program's ``trace_op`` on the ingest of
one pandas frame) that no ``host_to_device`` range (the device fill and
host-to-device copy of one host array, ``core/column.py:_pad_to``)
covers, in % of the traced window: the columns' conversion on the host,
during which the card idles."""
from portbench.harness import spans as sp
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    ingests = tr.outermost(ctx.trace, "Table.from_pandas")
    if not ingests:
        return None
    copies = sp.inside(ctx.trace, ingests, "host_to_device")
    free = sum(sp.uncovered_ns(span, c) for span, c in zip(ingests, copies))
    return 100 * free / (ctx.trace.window[1] - ctx.trace.window[0])
