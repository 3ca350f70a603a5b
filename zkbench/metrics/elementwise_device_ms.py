"""elementwise_device_ms: device ms a proof in PyTorch's own elementwise
kernels (``at::native``'s ``*elementwise_kernel*``): mostly the field
layer's (``fields/limb.py``) int64 adds, subtractions and selects."""

PATTERNS = (r"elementwise_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    n, us = t.match(PATTERNS)
    return us / 1e3 / t.jobs if n else None
