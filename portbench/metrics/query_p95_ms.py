"""query_p95_ms: the 95th percentile (nearest rank) of the latencies of
every operation completed in the window, in ms (host clock, each ending
with the result on the host)."""
import math


def read(ctx):
    lat = sorted(s for *_, s in ctx.latencies)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
