"""msm_device_ms: device ms a proof in the kernels that only the Pippenger
layer (``curves/msm.py``) launches on a prove's path: the bucket scan K4 in
both groups, the lane merge's levels (G1 and G2), the row gather K14, the
row scatter K16, and the digits' stable sort (cub's radix sort kernels,
through ``torch.sort``)."""

PATTERNS = (
    r"\bbucket_scan_kernel\b",
    r"\bpadd2?_seg_level_kernel\b",
    r"\bgather_planes_kernel\b",
    r"\bscatter_rows_kernel\b",
    r"RadixSort",
)


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs:
        return None
    n, us = t.match(PATTERNS)
    return us / 1e3 / t.jobs if n else None
