"""pair_kernels_ms_per_iter: device milliseconds of the hand-written
pair-update kernels K1-K4 per L-BFGS iteration of the traced window."""

from harness.kernel_names import PAIR_KERNELS


def read(run):
    if run.trace is None or not run.traced_iters:
        return None
    s = run.trace.device_s(PAIR_KERNELS)
    return 1e3 * s / run.traced_iters if s > 0 else None
