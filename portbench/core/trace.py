"""The profiled window of a ``--trace 1`` run and what the per-layer
readers take from it.

``profiled`` and the kernel-name table are copies of the port's
``diagnostics/device_time.py`` (``profiled``, ``wrapper_of``,
``KERNEL_NAMES``, ``host_launches``), and ``category`` of
``scripts/profile_torch_step.py`` ``_category``, so that a later change
to the program cannot move them. The window is profiled with 200 short
spin kernels first: the profiler can drop the first device records of a
window, and the lead takes that loss (a profile that kept none of the
lead is refused).
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

PAD_S = 0.05
LEAD_KERNELS = 200
LEAD_CYCLES = 2000
LEAD_NAME = "spin_kernel"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
# the span the benchmark puts around its traced chunk loop
WINDOW_SPAN = "portbench.window"

# the device kernel of each hand-written kernel of the port, by a part of
# its name, and the benchmark's name for it
KERNEL_NAMES = {"K2": "forcing_kernel", "K1": "rich_fused",
                "K3": "faces_div_kernel", "K5": "correct_kernel",
                "K4": "thomas_"}
HAND = ("forcing_kernel", "rich_fused", "faces_div_kernel",
        "reduce_partials", "correct_kernel", "thomas_")
GEMM = ("gemm", "Gemm", "sm90_", "cutlass", "cublas", "Kernel2")


def category(name: str) -> str:
    """"hand", "gemm" or "plain" for a device kernel's name."""
    if any(k in name for k in HAND):
        return "hand"
    if any(k in name for k in GEMM):
        return "gemm"
    return "plain"


def kernel_id(name: str) -> Optional[str]:
    """K1..K5 for a device kernel of the port's hand kernels, or None."""
    for kid, part in KERNEL_NAMES.items():
        if part in name:
            return kid
    return None


class Kernel(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Window(NamedTuple):
    """What one profiled window holds: its device kernels (the lead left
    out), the host span of the chunk loop, its host launch calls, and
    the host activities overlapping each instant (for the idle gaps)."""
    kernels: List[Kernel]
    start_us: float
    end_us: float
    host_launches: int
    host_ops: List[Tuple[str, float, float]]

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6


def profiled(fn):
    """Run fn() under torch.profiler, the device idle ``PAD_S`` s on
    either side and ``LEAD_KERNELS`` spin kernels first, fn inside the
    span ``WINDOW_SPAN``: (fn's result, ``Window``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        with record_function(WINDOW_SPAN):
            out = fn()
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = prof.events()
    if not any(e.device_type == DeviceType.CUDA and LEAD_NAME in e.name
               for e in events):
        raise RuntimeError(
            f"torch.profiler kept none of the {LEAD_KERNELS} lead kernels "
            "of its window: the profile may have lost the window's first "
            "kernels")
    spans = [e for e in events if e.name == WINDOW_SPAN
             and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} spans named {WINDOW_SPAN}")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    # the device rows less the lead and the window span's own row (the
    # profiler mirrors a host span onto the device's timeline)
    kernels = [Kernel(e.name, e.time_range.start, e.time_range.end)
               for e in events if e.device_type == DeviceType.CUDA
               and LEAD_NAME not in e.name and e.name != WINDOW_SPAN
               and e.time_range.end > e.time_range.start]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in LAUNCH_CALLS) - LEAD_KERNELS
    host_ops = [(e.name, e.time_range.start, e.time_range.end)
                for e in events if e.device_type == DeviceType.CPU
                and e.name != WINDOW_SPAN
                and e.time_range.start < w1 and e.time_range.end > w0]
    return out, Window(kernels, w0, w1, launches, host_ops)


def busy_us(kernels: List[Kernel], start_us: float, end_us: float) -> float:
    """The union of the kernels' intervals clipped to [start, end]."""
    spans = sorted((max(k.start_us, start_us), min(k.end_us, end_us))
                   for k in kernels)
    total, cur0, cur1 = 0.0, None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def idle_gaps(w: Window) -> List[Tuple[float, float]]:
    """The intervals of the window in which no kernel ran."""
    spans = sorted((k.start_us, k.end_us) for k in w.kernels)
    gaps, t = [], w.start_us
    for a, b in spans:
        if a > t:
            gaps.append((t, min(a, w.end_us)))
        t = max(t, b)
        if t >= w.end_us:
            break
    if t < w.end_us:
        gaps.append((t, w.end_us))
    return [(a, b) for a, b in gaps if b > a]


def device_ops(w: Window, top: int = 10) -> List[List]:
    """[[kernel name, seconds]] of the window's longest-running kernels."""
    by: Dict[str, float] = {}
    for k in w.kernels:
        by[k.name] = by.get(k.name, 0.0) + (k.end_us - k.start_us) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda r: -r[1])[:top]]


def gaps_by_host(w: Window, top: int = 10) -> List[List]:
    """[[host activity, seconds]]: the device's idle time in the window,
    each gap given to the innermost host operation running at its middle
    ("none" where the host ran none), summed by name, the largest first."""
    import bisect

    gaps = idle_gaps(w)
    mids = [0.5 * (a + b) for a, b in gaps]
    owner = [None] * len(gaps)          # (duration, name) of the innermost
    for name, s, e in w.host_ops:
        for i in range(bisect.bisect_left(mids, s),
                       bisect.bisect_left(mids, e)):
            if owner[i] is None or e - s < owner[i][0]:
                owner[i] = (e - s, name)
    by: Dict[str, float] = {}
    for (a, b), o in zip(gaps, owner):
        name = "none" if o is None else o[1]
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda r: -r[1])[:top]]
