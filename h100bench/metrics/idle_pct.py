"""idle_pct: the share of the untraced part of a traced run's window in
which nothing ran on the device.

The profiler's own cost per graph node stretches the traced window, so the
traced window's idle share reads the tracer.  Instead the device's busy
time per unit of work is taken from the trace (the union of the device
intervals over the flops of the traced evaluations, each charged the work
its runner gives its kind in ``run.work``), and charged to the evaluations
that ran after the profiler stopped:
1 - (busy per flop x untraced flops) / (the untraced wall)."""


def read(run):
    if run.trace is None or run.untraced_s <= 0 or not run.work:
        return None
    work = run.work
    traced = sum(run.traced_evals.get(k, 0) * work[k][0] for k in work)
    untraced = sum(run.untraced_evals.get(k, 0) * work[k][0] for k in work)
    busy = run.trace.busy_s()
    if traced <= 0 or untraced <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / traced * untraced / run.untraced_s)
