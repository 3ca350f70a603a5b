"""prove_s: wall seconds per proof job over the measured window.

The window opens when the first job starts and closes when the last job
started ends (host clock, each job ending in a device synchronize); its
length over the jobs that returned a proof."""


def read(ctx):
    jobs = ctx.run.jobs
    done = sum(1 for *_, ok in jobs if ok)
    if not done:
        return None
    return (max(end for _, _, end, _ in jobs) - min(start for _, start, _, _ in jobs)) / done
