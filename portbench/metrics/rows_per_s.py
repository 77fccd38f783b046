"""rows_per_s: base-table rows that the completed operations read, over
the whole window (host clock). An operation reads every row of each table
that the configuration's ``operations`` entry lists."""


def rows_read(spec: dict, op: str) -> int:
    return sum(spec["tables"][t]["rows"] for t in spec["operations"][op]["reads"])


def read(ctx):
    if not ctx.latencies:
        return None
    return sum(rows_read(ctx.spec, op) for op, *_ in ctx.latencies) / ctx.window_s
