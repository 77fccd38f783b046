"""device_idle.host_bound: ``device_idle`` in the cells that report
``rows_per_s.host_bound``, the metric it moves there."""
from portbench.harness import manifest


def read(ctx):
    return manifest.metric_module("device_idle").read(ctx)
