"""rows_per_s.host_bound: ``rows_per_s`` in the cells whose runs the
host's speed spreads (the joins' dispatch, ingest), under a bound of
their own so that ``rows_per_s`` keeps a tight one."""
from portbench.harness import manifest


def read(ctx):
    return manifest.metric_module("rows_per_s").read(ctx)
