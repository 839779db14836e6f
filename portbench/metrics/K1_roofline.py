"""K1's share of its roofline (%): the least time of its step work
(core/roofline.py) over its device time in the step."""

from core.roofline import field_bytes, least_seconds
from core.trace import kernel_id


def read(run):
    if run.traced is None:
        return None
    us = sum(k.end_us - k.start_us for k in run.traced.kernels
             if kernel_id(k.name) == "K1")
    if us <= 0:
        return None
    bound = least_seconds(field_bytes("K1", run.shape, run.itemsize))
    return 100.0 * bound * run.traced_steps / (us / 1e6)
