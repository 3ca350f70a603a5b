"""k1_device_ms: device ms a proof in K1, the Montgomery product, and its
chain (``csrc/mont_mul.cu``: ``mont_mul*_kernel``, ``mont_pow*_kernel``)."""

PATTERNS = (r"\bmont_(mul|pow)\w*_kernel\b",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    n, us = t.match(PATTERNS)
    return us / 1e3 / t.jobs if n else None
