"""join_roofline: the joins' bytes over the device time of every device
operation launched inside an outermost ``join`` range, against the HBM
peak, in %.

Bytes: each equi-join's key columns on both sides, read once at their
declared widths over the rows that reach the join (after its inputs'
filters), and its matched row pairs, written once as two row indices of
``index_bytes`` each (cudf's ``size_type``). The reference counts the
rows and pairs."""
from portbench.harness import trace as tr
from portbench.harness.peaks import HBM_BYTES_PER_S
from portbench.harness.widths import column_width


def join_bytes(spec: dict, join: dict) -> float:
    left = sum(column_width(spec, k) for k in join["left_keys"])
    right = sum(column_width(spec, k) for k in join["right_keys"])
    return (join["left_rows"] * left + join["right_rows"] * right
            + join["pairs"] * 2 * spec["index_bytes"])


def read(ctx):
    if ctx.trace is None:
        return None
    spans = tr.outermost(ctx.trace, "join")
    device_s = tr.device_s_launched_in(ctx.trace, spans) if spans else 0.0
    nbytes = sum(join_bytes(ctx.spec, j) for op, params, _ in ctx.latencies
                 for j in ctx.counts[(op, params)]["joins"])
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100 * nbytes / HBM_BYTES_PER_S / device_s
