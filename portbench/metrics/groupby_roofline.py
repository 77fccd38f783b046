"""groupby_roofline: the keyed groupbys' bytes over the device time of
every device operation launched inside an outermost ``groupby_aggregate``
range, against the HBM peak, in %.

Bytes: the GroupBy's key columns and the columns its aggregates read, at
the rows after its filter, read once at their declared widths, and the
result (keys and aggregates, one row a group), written once. A keyless
aggregate is a reduction and not counted. The reference counts the rows
and groups."""
from portbench.harness import trace as tr
from portbench.harness.peaks import HBM_BYTES_PER_S
from portbench.harness.widths import WIDTH, column_width


def groupby_bytes(spec: dict, gb: dict) -> float:
    keys = sum(column_width(spec, k) for k in gb["keys"])
    reads = sum(column_width(spec, c) for c in gb["reads"])
    out = keys + sum(WIDTH[t] for t in gb["out"])
    return gb["rows"] * (keys + reads) + gb["groups"] * out


def read(ctx):
    if ctx.trace is None:
        return None
    spans = tr.outermost(ctx.trace, "groupby_aggregate")
    device_s = tr.device_s_launched_in(ctx.trace, spans) if spans else 0.0
    nbytes = sum(groupby_bytes(ctx.spec, gb) for op, params, _ in ctx.latencies
                 for gb in ctx.counts[(op, params)]["groupbys"] if gb["keys"])
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100 * nbytes / HBM_BYTES_PER_S / device_s
