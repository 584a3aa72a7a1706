"""host_reads_per_iter: the program's device-to-host reads (the
``host_reads`` counter: the loop's stop and Armijo masks, the watchdog's
two values) per L-BFGS iteration of the untraced part of a traced run."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    split = S.untraced_split(run, snap) if snap else None
    return split["host_reads"] if split else None
