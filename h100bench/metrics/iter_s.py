"""iter_s: the window's wall time over all L-BFGS iterations completed in
it (line search, host reads, horizon boundaries and the watchdog
included)."""


def read(run):
    iters = sum(h.iters for h in run.horizons)
    return run.window_s / iters if iters else None
