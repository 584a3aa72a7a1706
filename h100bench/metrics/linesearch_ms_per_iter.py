"""linesearch_ms_per_iter: device milliseconds of the program replays under
the line search (``program.replay`` spans under ``lbfgs.linesearch``, timed
by CUDA events) per L-BFGS iteration of the untraced part of a traced run."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    split = S.untraced_split(run, snap) if snap else None
    return split["linesearch"] if split else None
