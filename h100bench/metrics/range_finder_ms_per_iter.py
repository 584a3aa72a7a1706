"""range_finder_ms_per_iter: device milliseconds of the rand route's
range-finder factorizations (cuSOLVER QR / LU kernels) per L-BFGS
iteration of the traced window."""

from harness.kernel_names import RANGE_FINDER


def read(run):
    if run.trace is None or not run.traced_iters:
        return None
    s = run.trace.device_s(RANGE_FINDER)
    return 1e3 * s / run.traced_iters if s > 0 else None
