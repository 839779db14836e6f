#!/usr/bin/env python3
"""Where one step of the PyTorch port spends its time on the card.

    python3 scripts/profile_torch_step.py [--steps 10] [--trace out.json]
                                          [--helmholtz direct]

Runs the flagship configuration (models/presets.py: shell 32x128x256
f32, bench opt-ins, seeded developed flow) on CUDA — with `--helmholtz
direct`, the same configuration with `helmholtz solver = direct` — and
reports
  * host-clock ms/step two ways: reading the step diagnostics every step
    (as BoussinesqModel.run does) and enqueueing all steps before one
    synchronize;
  * a torch.profiler window over the same steps: device time by kernel,
    grouped into the hand-written kernels (K1-K5), matrix products (the
    Poisson and Helmholtz transforms) and other PyTorch kernels, and the
    device's busy share of the window;
  * K4's launches one by one, told apart by their order in the step
    (the momentum solve comes before the temperature solve), and the
    copy kernels a step (PyTorch kernels named *copy*).
The last line of standard output is one JSON object with these numbers.
Needs one CUDA card; exits non-zero without one.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# K4's launches in the order of a direct step
K4_ORDER = ("momentum", "temperature")
HAND = ("forcing_kernel", "rich_fused", "faces_div_kernel",
        "reduce_partials", "correct_kernel", "thomas_")
GEMM = ("gemm", "Gemm", "sm90_", "cutlass", "cublas", "Kernel2")


def _category(name: str) -> str:
    if any(k in name for k in HAND):
        return "hand kernels (K1-K5)"
    if any(k in name for k in GEMM):
        return "matrix products (Poisson, Helmholtz transforms)"
    return "other PyTorch kernels"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled window")
    ap.add_argument("--helmholtz", choices=("auto", "direct"),
                    default="auto", help="the `helmholtz solver` setting")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)

    params = bench_params()
    params.numerics.helmholtz_solver = args.helmholtz
    model = BoussinesqModel(params, device="cuda")
    s = seed_developed_flow(model)
    for _ in range(args.warmup):
        s, d = model.step(s, BENCH_DT)
        d.solver_ok
    torch.cuda.synchronize()

    n = args.steps
    t0 = time.perf_counter()
    s1 = s
    for _ in range(n):
        s1, d = model.step(s1, BENCH_DT)
        if not d.solver_ok:            # the gate's per-step read
            print("profile_torch_step: a step missed its tolerance",
                  file=sys.stderr)
    torch.cuda.synchronize()
    ms_gated = (time.perf_counter() - t0) / n * 1e3

    t0 = time.perf_counter()
    s1 = s
    for _ in range(n):
        s1, d = model.step(s1, BENCH_DT)
    torch.cuda.synchronize()
    ms_enqueue = (time.perf_counter() - t0) / n * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s1 = s
        for _ in range(n):
            s1, d = model.step(s1, BENCH_DT)
            d.solver_ok
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        if t_us > 0:
            rows.append((e.key, t_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    # K4 launch by launch, in the order of the step
    k4 = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "thomas_" in e.name),
                key=lambda e: e.time_range.start)
    k4_ms = {}
    for i, e in enumerate(k4):
        what = K4_ORDER[i % len(K4_ORDER)]
        k4_ms[what] = k4_ms.get(what, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    k4_ms = {k: v / n for k, v in k4_ms.items()}
    copies = [r for r in rows if "copy" in r[0].lower()]
    device_ms = sum(r[1] for r in rows)
    cats = {}
    for name, ms, cnt in rows:
        c = _category(name)
        ms0, cnt0 = cats.get(c, (0.0, 0))
        cats[c] = (ms0 + ms, cnt0 + cnt)

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; helmholtz solver = {args.helmholtz}")
    print(f"ms/step (host clock): {ms_gated:.4f} reading the diagnostics "
          f"every step, {ms_enqueue:.4f} enqueued ahead")
    print(f"profiled window: {window_ms:.3f} ms for {n} steps; device "
          f"kernels {device_ms:.3f} ms -> busy share "
          f"{device_ms / window_ms:.4f}")
    print("device time by group (ms/step, launches/step):")
    for c, (ms, cnt) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"  {c:40s} {ms / n:9.4f}  {cnt / n:7.1f}")
    if k4:
        print(f"K4 launches: {len(k4) / n:.1f}/step; ms/step by launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in k4_ms.items()))
    print(f"copy kernels: {sum(r[2] for r in copies) / n:.1f}/step, "
          f"{sum(r[1] for r in copies) / n:.4f} ms/step")
    for kname, ms, cnt in copies:
        print(f"  {ms / n:9.4f}  {cnt / n:7.1f}  {kname[:90]}")
    print("top kernels (ms/step, launches/step):")
    for kname, ms, cnt in rows[:20]:
        print(f"  {ms / n:9.4f}  {cnt / n:7.1f}  {kname[:90]}")
    if not rows:
        print("profile_torch_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "device": name, "helmholtz_solver": args.helmholtz, "steps": n,
        "ms_per_step_gated": ms_gated,
        "ms_per_step_enqueued": ms_enqueue,
        "device_ms_per_step": device_ms / n,
        "busy_share": device_ms / window_ms,
        "groups_ms_per_step": {c: v[0] / n for c, v in cats.items()},
        "launches_per_step": sum(r[2] for r in rows) / n,
        "k4_ms_per_step": k4_ms,
        "copy_launches_per_step": sum(r[2] for r in copies) / n,
        "copy_ms_per_step": sum(r[1] for r in copies) / n,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
