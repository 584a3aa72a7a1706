"""evals_per_iter: replays of the cell's captured programs (value and
objective+gradient, the watchdog's check included) over the window's
L-BFGS iterations."""


def read(run):
    iters = sum(h.iters for h in run.horizons)
    evals = sum(p["window_replays"] for p in run.programs)
    return evals / iters if iters and evals else None
