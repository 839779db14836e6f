"""Device time of one call of a function that enqueues CUDA work.

Used by ``chip_smoke.py`` and ``scripts/probe_k1_k2.py``.
"""

from __future__ import annotations

import time

import torch

_CYCLES_PER_MS = []


def time_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean device time of one call (ms): one event pair around `reps`
    back-to-back calls after `warmup` calls. The calls are enqueued
    behind a device-side sleep longer than their enqueueing, so the
    host's launch cost stays out of the interval."""
    if not _CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(1e7 / a.elapsed_time(b))
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_CYCLES_PER_MS[0] * (2 * host_ms * reps + 5)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
