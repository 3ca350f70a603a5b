"""kernels_per_proof: device kernel launches a proof, counted from the
profiler's kernel events (the port's own CUDA kernels through ``_ext`` and
PyTorch's own), copies and memsets left out."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs or not t.kernels:
        return None
    return sum(c for c, _ in t.kernels.values()) / t.jobs
