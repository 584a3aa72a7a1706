"""host_loop_ms_per_iter: the L-BFGS iterations' wall outside the device
time of the replays issued inside them (the loop's Python, its reads'
bubbles, its eager vector operations) per iteration of the untraced part of
a traced run."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    split = S.untraced_split(run, snap) if snap else None
    return split["host_loop"] if split else None
