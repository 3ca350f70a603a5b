"""device_idle_share: the share of the traced jobs' wall time in which no
operation ran on the card: 1 - busy / window, busy the union of the device
events (kernels, copies, memsets) of the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 1 - t.busy_us / t.window_us
