"""K4's share of its roofline on the annulus's direct step (%): the
least time of the step's two radial solves (2 velocity components, then
the temperature; core/roofline.py) over K4's device time in the step."""

from core.roofline import least_seconds, tridiag_bytes
from core.trace import kernel_id


def read(run):
    if run.traced is None:
        return None
    us = sum(k.end_us - k.start_us for k in run.traced.kernels
             if kernel_id(k.name) == "K4")
    if us <= 0:
        return None
    bound = least_seconds(tridiag_bytes(run.shape, 2, run.itemsize)
                          + tridiag_bytes(run.shape, 1, run.itemsize))
    return 100.0 * bound * run.traced_steps / (us / 1e6)
