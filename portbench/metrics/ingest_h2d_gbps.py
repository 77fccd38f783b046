"""ingest_h2d_gbps: the configuration's logical bytes (rows times declared
widths, ``peak_mem_ratio.logical_bytes``), once for each outermost
``Table.from_pandas`` range, over the device time of the ``Memcpy HtoD``
operations launched inside those ranges, in GB/s (1e9 bytes). Logical
bytes do not change when the program changes its layout."""
from portbench.harness import manifest
from portbench.harness import spans as sp
from portbench.harness import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    ingests = tr.outermost(ctx.trace, "Table.from_pandas")
    copy_s = sp.device_s_named(ctx.trace, ingests, "Memcpy HtoD") if ingests else 0.0
    if copy_s <= 0:
        return None
    nbytes = manifest.metric_module("peak_mem_ratio").logical_bytes(ctx.spec) * len(ingests)
    return nbytes / 1e9 / copy_s
