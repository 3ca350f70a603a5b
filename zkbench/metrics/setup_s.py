"""setup_s: seconds from the start of the run's script to the window:
imports, loading (or, in a checkout's first run, building) the kernel
library, the inputs and keys, and the warm-up jobs."""


def read(ctx):
    return ctx.run.setup_s
