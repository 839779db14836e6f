#!/usr/bin/env python3
"""How exactly torch.profiler counts the hand kernels of one eager step
(diagnostics/device_time.py ``profiled``), against the wrappers' own
``launches``, which are exact.

    python3 scripts/probe_eager_profile.py [--trials 3] [--paths a,b]

Paths, all at the flagship's 32x128x256 f32 from the seeded developed
flow (models/presets.py): ``flagship`` (the default step, ~115 kernels),
``mimetic`` (the mimetic shell with the FEEC prm's physics, ~0.9k),
``cg64`` (`poisson solver = cg` with the CG capped at 64 iterations,
~4k) and ``mg`` (`poisson solver = mg`, ~51k). For each path and each
way of taking the profile ("lever"), ``--trials`` single-step profiles:

  * ``pad``: PAD_S of idle on either side, no lead (``profiled`` before
    its lead kernels);
  * ``pad0.5``: 0.5 s of idle on either side;
  * ``warmup``: a profiler cycle with ``schedule(wait=0, warmup=1,
    active=1)``: the step once while tracing is warming up (discarded),
    then the step again, recorded (``prof.events()`` accumulates the
    cycles; the raw events and the trace hold the last, empty one);
  * ``marker``: a small device kernel enqueued first inside the window;
  * ``lead200`` / ``lead2000``: 200 or 2000 short spin kernels
    (``torch.cuda._sleep``) enqueued first inside the window, ahead of
    fn; the probe counts how many of them the trace kept.

Each profile's hand kernels are counted three ways: ``prof.events()``
(what ``device_events`` reads), the raw kineto events
(``prof.profiler.kineto_results.events()``) and the exported chrome
trace (``prof.export_chrome_trace``). Where a count falls short of the
wrappers', the probe says whether the missing kernel is absent from the
raw trace (CUPTI dropped its record) or present with a timestamp outside
the window (the host-clock conversion), and prints the first device
events of the trace against the window's start. The last line of
standard output is one JSON object with every trial. Needs one CUDA
card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEC_PRM = os.path.join(HERE, "data", "aqua_planet_shell_test_3d-feec.prm")
PATHS = ("flagship", "mimetic", "cg64", "mg")
LEVERS = ("pad", "pad0.5", "warmup", "marker", "lead200", "lead2000")


def build(path, dev):
    """(model, state) of one path."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import make_model
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)

    if path == "mimetic":
        p = Parameters.from_file(FEEC_PRM)
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = \
            BENCH_SHAPE
        p.time_step = BENCH_DT
        p.adapt_time_step = False
        p.final_time = 1e9
        p.numerics.feec_formulation = "staggered"
    else:
        p = bench_params(BENCH_SHAPE)
        if path in ("cg64", "mg"):
            p.numerics.poisson_solver = path[:2]
        if path == "cg64":
            p.numerics.max_cg_iters = 64
    m = make_model(p, device=dev)
    return m, seed_developed_flow(m)


def raw_events(prof):
    """[(name, device kind, start ns)] of the raw kineto events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append((e.name(), str(e.device_type()), e.start_ns()))
    return out


def trace_kernels(prof):
    """[(name, ts µs)] of the kernels in the exported chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [(e.get("name", ""), float(e.get("ts", 0.0))) for e in evs
            if e.get("cat") == "kernel"]


def by_wrapper(names):
    from dycoreplanet_tpu_torch.diagnostics.device_time import wrapper_of
    counts = {}
    for n in names:
        w = wrapper_of(n)
        if w is not None:
            counts[w] = counts.get(w, 0) + 1
    return counts


def take(lever, fn):
    """One profile of fn() by ``lever``: (profiler, host perf_counter
    times of fn's call and return)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, schedule)
    from dycoreplanet_tpu_torch.diagnostics.device_time import PAD_S

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    pad = 0.5 if lever == "pad0.5" else PAD_S
    span = []
    torch.cuda.synchronize()
    if lever == "warmup":
        ready = []
        with profile(activities=acts, acc_events=True,
                     on_trace_ready=ready.append,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(2):
                time.sleep(pad)
                span[:] = [time.perf_counter()]
                fn()
                torch.cuda.synchronize()
                span.append(time.perf_counter())
                time.sleep(pad)
                prof.step()
        return prof, span
    with profile(activities=acts) as prof:
        time.sleep(pad)
        if lever == "marker":
            torch.cuda._sleep(1000)
        if lever.startswith("lead"):
            for _ in range(int(lever[4:])):
                torch.cuda._sleep(2000)
        span[:] = [time.perf_counter()]
        fn()
        torch.cuda.synchronize()
        span.append(time.perf_counter())
        time.sleep(pad)
    return prof, span


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--levers", default=",".join(LEVERS))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_eager_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from dycoreplanet_tpu_torch.diagnostics.device_time import wrapper_of
    from dycoreplanet_tpu_torch.ops import kernel_lib

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    kernel_lib.build_all()
    dev = torch.device("cuda")
    trials = []
    for path in args.paths.split(","):
        m, s0 = build(path, dev)
        dt = m.params.time_step
        fn = lambda: m.step(s0, dt)[1].cfl                  # noqa: E731
        for _ in range(2):
            fn()
        for lever in args.levers.split(","):
            for trial in range(args.trials):
                for k in m.kernels().values():
                    k.launches = 0
                prof, span = take(lever, fn)
                want = {k: v.launches for k, v in m.kernels().items()
                        if v.launches}
                if lever == "warmup":
                    # the step ran twice, the second recorded
                    want = {k: v // 2 for k, v in want.items()}
                evs = prof.events()
                dev_evs = [e for e in evs
                           if e.device_type == DeviceType.CUDA]
                got_ev = by_wrapper(e.name for e in dev_evs)
                raw = raw_events(prof)
                raw_dev = [r for r in raw if "CUDA" in r[1]]
                got_raw = by_wrapper(r[0] for r in raw_dev)
                tk = trace_kernels(prof)
                got_tr = by_wrapper(n for n, _ in tk)
                t0_ns = prof.profiler.kineto_results.trace_start_ns()
                spin = sum("spin_kernel" in r[0] for r in raw_dev)
                rec = dict(path=path, lever=lever, trial=trial, want=want,
                           spin_kept=spin,
                           events=got_ev, raw=got_raw, trace=got_tr,
                           n_device_events=len(dev_evs),
                           n_raw_device=len(raw_dev),
                           n_trace_kernels=len(tk),
                           host_ms=(span[1] - span[0]) * 1e3)
                miss = {k: v - got_ev.get(k, 0) for k, v in want.items()
                        if got_ev.get(k, 0) != v}
                rec["missing"] = miss
                if miss:
                    # where the missing kernels are: the raw trace's
                    # first device events and each hand kernel's start,
                    # relative to the trace's start (ms)
                    first = sorted(raw_dev, key=lambda r: r[2])[:8]
                    rec["first_raw_device_ms"] = [
                        (r[0][:60], (r[2] - t0_ns) / 1e6) for r in first]
                    rec["hand_raw_ms"] = sorted(
                        ((wrapper_of(r[0]), (r[2] - t0_ns) / 1e6)
                         for r in raw_dev if wrapper_of(r[0]) in miss),
                        key=lambda x: x[1])[:10]
                    rec["first_event_ms"] = sorted(
                        (e.time_range.start / 1e3 for e in dev_evs))[:3]
                    rec["first_cpu_launch_ms"] = sorted(
                        e.time_range.start / 1e3 for e in evs
                        if e.device_type == DeviceType.CPU
                        and e.name.startswith(("cudaLaunch", "cuLaunch")))[:3]
                trials.append(rec)
                print(f"{path:9s} {lever:8s} #{trial}  spin kept {spin}  host "
                      f"{rec['host_ms']:9.1f} ms  device events "
                      f"{len(dev_evs):6d} raw {len(raw_dev):6d} trace "
                      f"{len(tk):6d}  want {want}  events {got_ev}  raw "
                      f"{got_raw}  trace {got_tr}"
                      + (f"  MISSING {miss} first raw device events (ms "
                         f"from the trace start) "
                         f"{rec['first_raw_device_ms']} hand "
                         f"{rec['hand_raw_ms']} first events "
                         f"{rec['first_event_ms']} first launches "
                         f"{rec['first_cpu_launch_ms']}" if miss else ""),
                      flush=True)
        del m, s0
        torch.cuda.empty_cache()
    for path in args.paths.split(","):
        for lever in args.levers.split(","):
            mine = [t for t in trials
                    if t["path"] == path and t["lever"] == lever]
            bad = [t for t in mine if t["missing"]]
            raw_ok = sum(t["raw"] == t["want"] for t in mine)
            tr_ok = sum(t["trace"] == t["want"] for t in mine)
            print(f"{path} {lever}: {len(mine)} profiles, {len(bad)} short "
                  f"in prof.events(), raw exact {raw_ok}, trace exact "
                  f"{tr_ok}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "trials": trials}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
