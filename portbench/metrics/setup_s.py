"""setup_s: from the start of the process to the first timed operation
(host clock): imports, the kernels' build or load, making the data and
handing it to the port, and the warm-up of the mix's operations."""


def read(ctx):
    return ctx.setup_s
