"""Device time of one call of a function that enqueues CUDA work, and the
hand-written kernels it runs on the device.

Used by ``chip_smoke.py``, ``scripts/probe_k1_k2.py``,
``scripts/probe_replay_counts.py`` and ``scripts/profile_torch_step.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_CYCLES_PER_MS = []

# host seconds of device idle kept on either side of a profiled call
# (scripts/probe_replay_counts.py)
PAD_S = 0.05
# short spin kernels (torch.cuda._sleep) enqueued first in a profiled
# window, ahead of the call: an eager window can lose its first device
# records (up to 34 of them on an NVIDIA H100, absent from the raw trace,
# whatever the padding); the lead takes that loss, and a profile that
# kept none of it is refused (scripts/probe_eager_profile.py)
LEAD_KERNELS = 200
LEAD_CYCLES = 2000
LEAD_NAME = "spin_kernel"
# host-side calls that launch device work (kernels or graphs)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")

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
    seconds of host time on either side of it and ``LEAD_KERNELS`` spin
    kernels enqueued just before it: (fn's result, the profiler). The
    profiler keeps only the device activities whose times, as converted
    to the host's clock, fall inside its window, and that conversion has
    put kernels milliseconds before the call that launched them:
    unpadded, the first kernels of fn can be lost. Besides, a window can
    lose its first device records altogether (eager steps of 4k and 51k
    kernels lost K2 and K1 so): the lead kernels come first and take
    that loss; a profile that kept none of them may have lost fn's first
    kernels too, and raises. Read the profile through
    ``device_events``, ``device_rows``, ``host_launches`` and
    ``count_kernels``, which leave the lead out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(LEAD_CYCLES)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    if not any(e.device_type == DeviceType.CUDA and LEAD_NAME in e.name
               for e in prof.events()):
        raise RuntimeError(
            f"torch.profiler kept none of the {LEAD_KERNELS} lead kernels "
            "of its window: the profile may have lost the call's first "
            "kernels")
    return out, prof


def device_events(prof) -> List:
    """The device activities of a ``profiled`` window, its lead kernels
    left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and LEAD_NAME not in e.name]


def device_rows(prof) -> List[Tuple[str, float, int]]:
    """[(kernel name, device ms, count)] of a ``profiled`` window's
    device activities of nonzero time, longest first, its lead kernels
    left out."""
    rows: Dict[str, Tuple[float, int]] = {}
    for e in device_events(prof):
        us = e.time_range.end - e.time_range.start
        if us > 0:
            ms, n = rows.get(e.name, (0.0, 0))
            rows[e.name] = (ms + us / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in rows.items()),
                  key=lambda r: -r[1])


def host_launches(prof) -> int:
    """The host calls of a ``profiled`` window that launch device work
    (``LAUNCH_CALLS``), the lead kernels' own launches left out."""
    n = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
    return n - LEAD_KERNELS


def count_kernels(prof, names: Iterable[str]) -> Dict[str, int]:
    """The hand-written kernels of a ``profiled`` window, by wrapper
    name: {name: count} for every name of ``names``."""
    counts: Dict[str, int] = {name: 0 for name in names}
    for e in device_events(prof):
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


def time_ms(fn, reps: int = 50, warmup: int = 3,
            host_budget_ms: float = 250.0) -> float:
    """Mean device time of one call (ms): one event pair around `reps`
    back-to-back calls after `warmup` calls. The calls are enqueued
    behind a device-side sleep longer than their enqueueing, so the
    host's launch cost stays out of the interval. A call whose warm-up
    took more than ``host_budget_ms / reps`` of host time (a plain
    version of many small launches) is timed over fewer calls, as many
    as fit in ``host_budget_ms``, and never fewer than 5."""
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
    reps = max(min(reps, 5),
               min(reps, int(host_budget_ms / max(host_ms, 1e-6))))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_CYCLES_PER_MS[0] * (2 * host_ms * reps + 5)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
