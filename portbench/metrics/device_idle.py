"""device_idle: the share of the traced window in which no kernel, copy
or set runs on the card (torch.profiler's CUDA activity), in %."""
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100 * (1 - tr.busy_s(ctx.trace) / ctx.trace.window_s)
