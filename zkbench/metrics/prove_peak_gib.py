"""prove_peak_gib: the card memory the window's proofs need, in GiB.

``torch.cuda.max_memory_allocated`` over the window, whose count is reset
when the window opens: what set-up made and still holds (keys, inputs)
counts, its freed transients do not."""


def read(ctx):
    peak = ctx.run.window_peak_bytes
    return peak / 2**30 if peak else None
