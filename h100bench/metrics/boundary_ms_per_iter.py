"""boundary_ms_per_iter: the horizons' wall outside their L-BFGS iterations
(``asp.horizon`` spans minus their ``lbfgs.iteration`` children: the start
point's objective and gradient, the watchdog's check, the extraction) per
iteration of the untraced part of a traced run."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    split = S.untraced_split(run, snap) if snap else None
    return split["boundary"] if split else None
