"""Share of the traced window in which no kernel ran (%)."""

from core.trace import busy_us


def read(run):
    w = run.traced
    if w is None:
        return None
    return 100.0 * (1.0 - busy_us(w.kernels, w.start_us, w.end_us)
                    / (w.end_us - w.start_us))
