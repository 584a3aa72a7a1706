"""engine_ms_per_iter: device-busy milliseconds per L-BFGS iteration of
the traced window outside K1-K4 and the range-finder: the MPS engine's
contractions, gathers and copies, and the optimizer's own device work."""

from harness.kernel_names import PAIR_KERNELS, RANGE_FINDER


def read(run):
    if run.trace is None or not run.traced_iters:
        return None
    s = run.trace.busy_s() - run.trace.device_s(PAIR_KERNELS) - run.trace.device_s(RANGE_FINDER)
    return 1e3 * s / run.traced_iters if s > 0 else None
