"""nccl_device_ms: device ms a proof in NCCL's kernels on rank 0's trace:
the quotient's all_to_all exchanges, the MSMs' gathers of partial sums, and
rank 0's wait in them for the slowest rank.  NCCL's kernels are not the
port's: no roofline share reads them."""

PATTERNS = (r"(?i)nccl",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    n, us = t.match(PATTERNS)
    return us / 1e3 / t.jobs if n else None
