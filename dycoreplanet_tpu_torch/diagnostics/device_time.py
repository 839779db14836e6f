"""Device time of one call of a function that enqueues CUDA work, and the
hand-written kernels it runs on the device.

Used by ``chip_smoke.py``, ``scripts/probe_k1_k2.py``,
``scripts/probe_replay_counts.py`` and ``scripts/profile_torch_step.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import torch

_CYCLES_PER_MS = []

# host seconds of device idle kept on either side of a profiled call
# (scripts/probe_replay_counts.py)
PAD_S = 0.05

# the device kernel each wrapper of BoussinesqModel.kernels() launches, by
# a part of its name (K3's wrapper also launches a reduce_partials kernel)
KERNEL_NAMES = {"forcing": "forcing_kernel", "richardson": "rich_fused",
                "faces_div": "faces_div_kernel", "correct": "correct_kernel",
                "tridiag": "thomas_"}
# the instances of K1 and K2 by their template arguments: (the argument's
# position, the wrapper when it is false) for K1u (TRACK) and K2m
# (ADVECT_T), and the position of OPS, true for K1o, K2o and K2mo (the
# operands mode of K2m: "forcing_momentum_operands")
VARIANTS = {"richardson": (5, "richardson_free"),
            "forcing": (1, "forcing_momentum")}
OPERANDS = {"richardson": 6, "forcing": 2}


def template_args(kernel: str, part: str):
    """The template arguments of a demangled kernel name after ``part``."""
    tail = kernel.split(part, 1)[1]
    if not tail.startswith("<"):
        return []
    return [a.strip() for a in tail[1:].split(">", 1)[0].split(",")]


def is_false(arg: str) -> bool:
    """Whether a demangled bool template argument is false."""
    return arg in ("false", "(bool)0", "0")


def wrapper_of(kernel: str) -> Optional[str]:
    """The name in ``BoussinesqModel.kernels()`` of the wrapper that
    launches the device kernel named ``kernel``, or None."""
    for wrapper, part in KERNEL_NAMES.items():
        if part in kernel:
            args = template_args(kernel, part)
            if wrapper in OPERANDS:
                at = OPERANDS[wrapper]
                ops = len(args) > at and not is_false(args[at])
                at, name = VARIANTS[wrapper]
                name = (name if len(args) > at and is_false(args[at])
                        else wrapper)
                return f"{name}_operands" if ops else name
            return wrapper
    return None


def profiled(fn, pad_s: float = PAD_S):
    """Run fn() under torch.profiler, the device idle for ``pad_s``
    seconds of host time on either side of it: (fn's result, the
    profiler). The profiler keeps only the device activities whose
    times, as converted to the host's clock, fall inside its window, and
    that conversion has put kernels milliseconds before the call that
    launched them: unpadded, the first kernels of fn can be lost."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return out, prof


def count_kernels(prof, names: Iterable[str]) -> Dict[str, int]:
    """The hand-written kernels of a profile, by wrapper name: {name:
    count} for every name of ``names``."""
    from torch.autograd import DeviceType

    counts: Dict[str, int] = {name: 0 for name in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            w = wrapper_of(e.name)
            if w in counts:
                counts[w] += 1
    return counts


def device_launches(fn, names: Iterable[str]):
    """Run fn() under torch.profiler and count the hand-written kernels
    that ran on the device, by wrapper name: (fn's result, {name:
    count} for every name of ``names``). Unlike the wrappers' own
    ``launches``, this counts the kernels a CUDA graph replay runs."""
    out, prof = profiled(fn)
    return out, count_kernels(prof, names)


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
