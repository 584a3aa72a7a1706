"""grad_ms_per_iter: device milliseconds of the replays of the accepted
point's objective and gradient (``program.replay`` spans under
``lbfgs.grad``) per L-BFGS iteration of the untraced part of a traced run."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    split = S.untraced_split(run, snap) if snap else None
    return split["grad"] if split else None
