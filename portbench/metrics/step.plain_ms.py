"""Device ms a step of the kernels that are neither hand kernels nor
matrix products (the step's plain PyTorch ops)."""

from core.trace import category


def read(run):
    if run.traced is None:
        return None
    us = sum(k.end_us - k.start_us for k in run.traced.kernels
             if category(k.name) == "plain")
    return us / 1e3 / run.traced_steps
