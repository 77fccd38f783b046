"""query_p95_ms.host_bound: ``query_p95_ms`` in the cells whose runs the
host's speed spreads, under a bound of their own."""
from portbench.harness import manifest


def read(ctx):
    return manifest.metric_module("query_p95_ms").read(ctx)
