"""peak_mem_ratio: ``torch.cuda.max_memory_allocated()`` over the window
(its peak reset at the start) over the configuration's logical data
bytes: rows times declared widths, no padding."""
from portbench.harness.widths import WIDTH


def logical_bytes(spec: dict) -> float:
    total = 0.0
    for table in spec["tables"].values():
        width = sum(WIDTH[t] for t in table["columns"].values())
        bits = sum(1 for c in table["columns"] if c in spec["nullable"])
        total += table["rows"] * (width + bits / 8)
    return total


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / logical_bytes(ctx.spec)
