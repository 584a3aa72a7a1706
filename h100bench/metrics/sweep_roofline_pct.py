"""sweep_roofline_pct: the least time an H100 could take for the work of
the traced window's evaluations, over the traced window's wall.

The work of one evaluation of each kind is what the cell's runner gives in
``run.work`` (for the MPS runners the frozen census of work/census.py at
the cell's circuit and chi, each pair update charged the same
route-independent count); the evaluations are the runner's replays in the
traced window.  The least time is the larger of flops / 67 TFLOP/s
(float32 outside the tensor cores) and bytes / 3.35 TB/s; a note says
which bounds it."""

from work import census as W


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not sum(run.traced_evals.values()) or not run.work:
        return None
    work = run.work
    flops = sum(run.traced_evals.get(k, 0) * work[k][0] for k in work)
    nbytes = sum(run.traced_evals.get(k, 0) * work[k][1] for k in work)
    t_flops, t_bytes = flops / W.PEAK_F32_FLOPS, nbytes / W.PEAK_HBM_BYTES
    run.notes.append(f"sweep_roofline_pct: {flops:.6g} flop, {nbytes:.6g} B in {run.traced_evals} evaluations; "
                     f"bound by {'flops' if t_flops >= t_bytes else 'bytes'}")
    return 100.0 * max(t_flops, t_bytes) / run.trace.window_s
