"""compaction_share: the summed host time of the outermost
``apply_boolean_mask`` ranges (the program's ``trace_op`` on
``ops/stream_compaction.py:apply_boolean_mask``, which every filter of the
IR and the frame takes), in % of the traced window. A compaction waits for
its output size, so its host time is its time."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    return tr.range_share(ctx.trace, "apply_boolean_mask")
