"""Device ms a step of the matrix-product kernels (the fast
diagonalization's and the direct solves' transforms)."""

from core.trace import category


def read(run):
    if run.traced is None:
        return None
    us = sum(k.end_us - k.start_us for k in run.traced.kernels
             if category(k.name) == "gemm")
    return us / 1e3 / run.traced_steps
