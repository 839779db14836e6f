#!/usr/bin/env python3
"""How reliably torch.profiler counts the hand kernels of a CUDA graph
replay (diagnostics/device_time.py ``device_launches``).

    python3 scripts/probe_replay_counts.py [--seconds 150] [--pads 0,0.05]

Runs the flagship configuration (models/presets.py: shell 32x128x256
f32, bench opt-ins, seeded developed flow) on CUDA, captures the
20-step ``multi_step`` chunk with and without collected diagnostics,
and then, until ``--seconds`` have passed, profiles one replay of each
with every padding of ``--pads`` (host seconds of device idle on either
side of the call, ``device_time.profiled``) in turn. For each profile:
the hand kernels counted against the 20 launches of each that the
replay makes, the device events kept, and the lag of each device event
behind the host call that launched it (converted device time minus
host time; a launch cannot start before its call, so a negative lag is
the error of the profiler's clock conversion). A miss prints the first
and last K2 starts relative to the graph launch. The last line of
standard output is one JSON object with every trial. Needs one CUDA
card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_STEPS = 20


def lags_us(prof):
    """(device events, min lag, the graph launch's host start, device
    starts of K2) in µs from the trace's start, by correlation id."""
    from torch.autograd import DeviceType
    from dycoreplanet_tpu_torch.diagnostics.device_time import device_events

    calls = {e.id: e for e in prof.events() if e.device_type == DeviceType.CPU
             and e.name.startswith("cuda")}
    dev = device_events(prof)
    lags = [e.time_range.start - calls[e.id].time_range.start
            for e in dev if e.id in calls]
    launch = [e.time_range.start for e in calls.values()
              if e.name.startswith("cudaGraphLaunch")]
    k2 = sorted(e.time_range.start for e in dev
                if "forcing_kernel" in e.name)
    return (len(dev), min(lags) if lags else None,
            launch[0] if launch else None, k2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--pads", default="0,0.05")
    args = ap.parse_args()
    pads = [float(x) for x in args.pads.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("probe_replay_counts: needs a CUDA card", file=sys.stderr)
        return 1
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        count_kernels, profiled)
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    model = BoussinesqModel(bench_params(), device="cuda")
    s0 = seed_developed_flow(model)
    want = {"forcing": N_STEPS, "richardson": N_STEPS, "faces_div": 0,
            "correct": N_STEPS, "tridiag": 0}
    for collect in (True, False):
        model.multi_step(s0, BENCH_DT, N_STEPS, collect_diagnostics=collect)
    trials = []
    while time.perf_counter() - t0 < args.seconds:
        for pad in pads:
            for collect in (True, False):
                def chunk():
                    return model.multi_step(s0, BENCH_DT, N_STEPS,
                                            collect_diagnostics=collect)
                _, prof = profiled(chunk, pad)
                counts = {k: v for k, v in count_kernels(
                    prof, model.kernels()).items() if k in want}
                n_dev, lag, launch, k2 = lags_us(prof)
                t = dict(t_s=time.perf_counter() - t0, pad_s=pad,
                         collect=collect, ok=counts == want,
                         counts=counts, device_events=n_dev,
                         min_lag_us=lag)
                trials.append(t)
                line = (f"t {t['t_s']:7.1f} s  pad {pad:5.3f}  collect "
                        f"{collect!s:5}  ok {t['ok']!s:5}  device events "
                        f"{n_dev:5d}  min lag {lag} us")
                if not t["ok"]:
                    rel = [x - launch for x in k2] if launch else k2
                    line += (f"  counts {counts}  K2 starts after the "
                             f"graph launch (us) {rel[:2]} ... {rel[-2:]}")
                print(line, flush=True)
    for pad in pads:
        mine = [t for t in trials if t["pad_s"] == pad]
        lags = [t["min_lag_us"] for t in mine if t["min_lag_us"] is not None]
        print(f"pad {pad}: {len(mine)} profiles, "
              f"{sum(not t['ok'] for t in mine)} miscounted, min lag "
              f"{min(lags) if lags else None} us, first/last "
              f"{lags[:1]} / {lags[-1:]} us", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "trials": trials}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
