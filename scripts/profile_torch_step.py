#!/usr/bin/env python3
"""Where one step of the PyTorch port spends its time on the card.

    python3 scripts/profile_torch_step.py [--steps 10] [--trace out.json]
        [--helmholtz direct] [--nse-interval K]
        [--residual-check-interval M] [--chunk N]
        [--temperature-advection semi-lagrangian]
        [--prm FILE | --geometry annulus] [--feec projection|coupled]

Runs the flagship configuration (models/presets.py: shell 32x128x256
f32, bench opt-ins, seeded developed flow) on CUDA — with `--helmholtz
direct`, the same configuration with `helmholtz solver = direct`; with
`--nse-interval K` / `--residual-check-interval M` /
`--temperature-advection` those settings. With `--prm FILE` it runs that
parameter file instead, in f32 at its own grid and dt from its initial
state; `--feec` the flagship with `use FEEC solver = true` and that
`momentum solver` (the rotational forcing in plain PyTorch; the coupled
3x3 FGMRES, which reads back every iteration: no `--chunk` there);
`--geometry annulus` runs data/aqua_planet_test_2d.prm at
`initial global refinement = 8`, the annulus of 256 x 3072 cells (the
prm's own grid is 16 x 192). It reports
  * host-clock ms/step of the eager loop two ways: reading the step's
    solver_ok every step (the gate, as BoussinesqModel.run does) and
    enqueueing all steps before one synchronize; the steps are NSE steps
    or temperature substeps by step_number, as run dispatches them;
  * a torch.profiler window over the same eager steps: device time by
    kernel, grouped into the hand-written kernels (K1-K5; K1 and its
    residual-free variant K1u told apart by their TRACK template
    argument, K2 and K2m by ADVECT_T), matrix products (the Poisson and
    Helmholtz transforms) and other PyTorch kernels, the device's busy
    share of the window, device kernels a step and host launches a step
    (kernel and graph launch calls of the CUDA runtime and its low-level
    API, cuLaunch*);
  * with the semi-Lagrangian transport: the device time of one call
    (CUDA events around back-to-back calls) and its device kernels (a
    profiled call), on the state the steps start from; an NSE step and
    a temperature substep each make one such call;
  * K4's launches one by one, told apart by their order in the step
    (the momentum solve comes before the temperature solve), and the
    copy kernels a step (PyTorch kernels named *copy*);
  * with `--chunk N`: the same steps through `multi_step` in chunks of N
    steps, one CUDA graph replay a chunk (after one chunk that captures
    the graph): host-clock ms/step with the chunk's diagnostics pulled,
    a profiler window over the replays (device time, busy share, host
    launches a step), device ms/step between CUDA events around
    back-to-back replays, host-clock ms/step without collected
    diagnostics (the JAX bench's form of multi_step), and
    `torch.cuda.max_memory_allocated` of the first chunk (its capture
    included) against that of the eager steps.
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
# the instances of K1 and K2, by the wrapper that launches them
VARIANT = {"richardson": "K1", "richardson_free": "K1u", "forcing": "K2",
           "forcing_momentum": "K2m", "richardson_operands": "K1o",
           "forcing_operands": "K2o", "forcing_momentum_operands": "K2mo"}


def _category(name: str) -> str:
    if any(k in name for k in HAND):
        return "hand kernels (K1-K5)"
    if any(k in name for k in GEMM):
        return "matrix products (Poisson, Helmholtz transforms)"
    return "other PyTorch kernels"


def _window(prof, n, window_ms):
    """Device time, launches and groups of one profiled window of n
    steps."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        device_rows, host_launches, wrapper_of)

    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    cats, var = {}, {}
    for name, ms, cnt in rows:
        c = _category(name)
        ms0, cnt0 = cats.get(c, (0.0, 0))
        cats[c] = (ms0 + ms, cnt0 + cnt)
        v = VARIANT.get(wrapper_of(name))
        if v is not None:
            ms0, cnt0 = var.get(v, (0.0, 0))
            var[v] = (ms0 + ms, cnt0 + cnt)
    return {
        "rows": rows,
        "device_ms_per_step": device_ms / n,
        "busy_share": device_ms / window_ms,
        "kernels_per_step": sum(r[2] for r in rows) / n,
        "host_launches_per_step": host_launches(prof) / n,
        "groups_ms_per_step": {c: v[0] / n for c, v in cats.items()},
        "groups_kernels_per_step": {c: v[1] / n for c, v in cats.items()},
        "variant_ms_per_step": {v: t[0] / n for v, t in var.items()},
        "variant_launches_per_step": {v: t[1] / n for v, t in var.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the eager window (its "
                         "first kernels: profiled's lead spin kernels)")
    ap.add_argument("--helmholtz", choices=("auto", "direct"),
                    default="auto", help="the `helmholtz solver` setting")
    ap.add_argument("--nse-interval", type=int, default=1,
                    help="the `NSE solver interval` setting")
    ap.add_argument("--residual-check-interval", type=int, default=1,
                    help="the `residual check interval` setting")
    ap.add_argument("--temperature-advection",
                    choices=("eulerian", "semi-lagrangian"),
                    default="eulerian",
                    help="the `temperature advection` setting")
    ap.add_argument("--chunk", type=int, default=0,
                    help="also run multi_step in chunks of this many steps "
                         "(CUDA graph replays)")
    ap.add_argument("--prm", default=None,
                    help="run this parameter file (f32, its own grid, dt "
                         "and initial state) instead of the flagship")
    ap.add_argument("--feec", choices=("projection", "coupled"),
                    default=None,
                    help="the flagship with `use FEEC solver = true` and "
                         "this `momentum solver`")
    ap.add_argument("--geometry", choices=("shell", "annulus"),
                    default="shell",
                    help="annulus: data/aqua_planet_test_2d.prm at "
                         "refinement 8 (256 x 3072)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        device_events, profiled, time_ms)
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, bench_params, seed_developed_flow)

    if args.geometry == "annulus":
        args.prm = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "aqua_planet_test_2d.prm")
    if args.prm is None:
        params = bench_params()
    else:
        from dycoreplanet_tpu_torch.base.params import Parameters

        params = Parameters.from_file(args.prm)
        params.numerics.dtype = "float32"
        if args.geometry == "annulus":
            params.initial_global_refinement = 8
    if args.feec is not None:
        params.use_FEEC_solver = True
        params.numerics.momentum_solver = args.feec
    params.numerics.helmholtz_solver = args.helmholtz
    params.NSE_solver_interval = args.nse_interval
    params.numerics.residual_check_interval = args.residual_check_interval
    params.numerics.temperature_advection = args.temperature_advection
    model = BoussinesqModel(params, device="cuda")
    if args.prm is None:
        s, dt = seed_developed_flow(model), BENCH_DT
    else:
        s, dt = model.initial_state(), params.time_step

    def eager_step(state):
        if state.step_number % params.NSE_solver_interval == 0:
            return model.step(state, dt)
        return model.temperature_step(state, dt)

    for _ in range(args.warmup):
        s, d = eager_step(s)
        d.solver_ok
    torch.cuda.synchronize()

    # every measured window (and chunk) starts from s at step_number 0,
    # so that each runs the same sequence of steps and substeps
    n = args.steps
    period = args.nse_interval * args.residual_check_interval
    s = s._replace(step_number=0)
    missed = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s1 = s
    for _ in range(n):
        s1, d = eager_step(s1)
        missed += not d.solver_ok         # the gate's per-step read
    torch.cuda.synchronize()
    ms_gated = (time.perf_counter() - t0) / n * 1e3
    eager_peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    s1 = s
    for _ in range(n):
        s1, d = eager_step(s1)
    torch.cuda.synchronize()
    ms_enqueue = (time.perf_counter() - t0) / n * 1e3

    window = []

    def eager_window():
        t0 = time.perf_counter()
        s1 = s
        for _ in range(n):
            s1, d = eager_step(s1)
            d.solver_ok
        torch.cuda.synchronize()
        window.append((time.perf_counter() - t0) * 1e3)

    _, prof = profiled(eager_window)
    window_ms = window[-1]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    eager = _window(prof, n, window_ms)
    rows = eager.pop("rows")
    # K4 launch by launch, in the order of the step
    k4 = sorted((e for e in device_events(prof) if "thomas_" in e.name),
                key=lambda e: e.time_range.start)
    k4_ms = {}
    for i, e in enumerate(k4):
        what = K4_ORDER[i % len(K4_ORDER)]
        k4_ms[what] = k4_ms.get(what, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    k4_ms = {k: v / n for k, v in k4_ms.items()}
    copies = [r for r in rows if "copy" in r[0].lower()]

    sl_out = None
    if model._semi_lagrangian is not None:
        sl_args = (s.u, s.T, model._dt_T(dt))
        sl_ms = time_ms(lambda: model._semi_lagrangian(*sl_args))
        _, sl_prof = profiled(lambda: model._semi_lagrangian(*sl_args))
        sl_out = {"ms_per_call": sl_ms,
                  "kernels_per_call": len(device_events(sl_prof))}

    name = torch.cuda.get_device_name(0)
    print(f"configuration: {args.prm or 'flagship (models/presets.py)'}, "
          f"{model.geo.kind} {model.geo.cell_shape}, dt {dt}")
    print(f"device: {name}; helmholtz solver = {args.helmholtz}, NSE "
          f"solver interval = {args.nse_interval}, residual check interval "
          f"= {args.residual_check_interval}, temperature advection = "
          f"{args.temperature_advection}")
    print(f"eager ms/step (host clock): {ms_gated:.4f} reading the gate "
          f"every step, {ms_enqueue:.4f} enqueued ahead ({missed} missed)")
    print(f"eager profiled window: {window_ms:.3f} ms for {n} steps; device "
          f"kernels {eager['device_ms_per_step'] * n:.3f} ms -> busy share "
          f"{eager['busy_share']:.4f}; {eager['kernels_per_step']:.1f} "
          f"device kernels and {eager['host_launches_per_step']:.1f} host "
          f"launches a step")
    print("device time by group (ms/step, kernels/step):")
    for c, ms in sorted(eager["groups_ms_per_step"].items(),
                        key=lambda kv: -kv[1]):
        print(f"  {c:40s} {ms:9.4f}  "
              f"{eager['groups_kernels_per_step'][c]:7.1f}")
    for v, ms in sorted(eager["variant_ms_per_step"].items()):
        print(f"  {v}: {ms:.4f} ms/step in "
              f"{eager['variant_launches_per_step'][v]:.2f} launches/step")
    if k4:
        print(f"K4 launches: {len(k4) / n:.1f}/step; ms/step by launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in k4_ms.items()))
    if sl_out is not None:
        print(f"semi-Lagrangian transport: {sl_out['ms_per_call']:.4f} ms of "
              f"device time and {sl_out['kernels_per_call']} device kernels "
              f"a call (one a step, one a substep)")
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
    out = {
        "device": name, "prm": args.prm, "geometry": model.geo.kind,
        "cells": list(model.geo.cell_shape), "dt": dt,
        "helmholtz_solver": args.helmholtz,
        "nse_interval": args.nse_interval,
        "residual_check_interval": args.residual_check_interval,
        "temperature_advection": args.temperature_advection,
        "semi_lagrangian": sl_out, "steps": n, "ms_per_step_gated": ms_gated,
        "ms_per_step_enqueued": ms_enqueue, "eager_missed": missed,
        "eager_peak_bytes": eager_peak, **eager,
        "k4_ms_per_step": k4_ms,
        "copy_launches_per_step": sum(r[2] for r in copies) / n,
        "copy_ms_per_step": sum(r[1] for r in copies) / n,
    }

    if args.chunk:
        N = args.chunk
        if n % N or N % period:
            print(f"profile_torch_step: --steps {n} must be a multiple of "
                  f"--chunk {N}, and --chunk of the intervals' product "
                  f"{period}", file=sys.stderr)
            return 1
        chunks = n // N
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.multi_step(s, dt, N)            # capture + replay
        torch.cuda.synchronize()
        graph_peak = torch.cuda.max_memory_allocated()
        graphs = model.chunk_graphs
        esc0 = model.escalations

        def replay_chunks():
            s1 = s
            for _ in range(chunks):
                s1, packed, _ = model.multi_step(s1, dt, N)
                packed.cpu()                 # the chunk's one pull
            return s1

        replay_chunks()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay_chunks()
        torch.cuda.synchronize()
        ms_chunked = (time.perf_counter() - t0) / n * 1e3
        # the JAX bench's form: no collected diagnostics, only the
        # gate's pull a chunk
        model.multi_step(s, dt, N, collect_diagnostics=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s1 = s
        for _ in range(chunks):
            s1, _, _ = model.multi_step(s1, dt, N,
                                        collect_diagnostics=False)
        torch.cuda.synchronize()
        ms_bench_form = (time.perf_counter() - t0) / n * 1e3
        def graph_window():
            t0 = time.perf_counter()
            replay_chunks()
            torch.cuda.synchronize()
            window.append((time.perf_counter() - t0) * 1e3)

        _, gprof = profiled(graph_window)
        gwindow_ms = window[-1]
        graph = _window(gprof, n, gwindow_ms)
        graph.pop("rows")
        # device time between events around back-to-back replays (no
        # pull between chunks), behind a device sleep
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10 ** 8)
        a.record()
        s1 = s
        for _ in range(chunks):
            s1, _, _ = graphs.run(s1, dt, N, True)
        b.record()
        b.synchronize()
        ev_ms = a.elapsed_time(b) / n
        if model.escalations != esc0:
            print("profile_torch_step: a chunk escalated", file=sys.stderr)
            return 1
        print(f"multi_step, chunks of {N} (CUDA graph replays; "
              f"{graphs.captures} capture(s), {graphs.replays} replays):")
        print(f"  ms/step (host clock, the chunk's diagnostics pulled): "
              f"{ms_chunked:.4f}; without collected diagnostics "
              f"{ms_bench_form:.4f}")
        print(f"  profiled window: {gwindow_ms:.3f} ms for {n} steps; device "
              f"kernels {graph['device_ms_per_step'] * n:.3f} ms -> busy "
              f"share {graph['busy_share']:.4f}; "
              f"{graph['kernels_per_step']:.1f} device kernels and "
              f"{graph['host_launches_per_step']:.2f} host launches a step")
        print(f"  device ms/step between events around {chunks} "
              f"back-to-back replays: {ev_ms:.4f}")
        for v, ms in sorted(graph["variant_ms_per_step"].items()):
            print(f"  {v}: {ms:.4f} ms/step in "
                  f"{graph['variant_launches_per_step'][v]:.2f} "
                  f"launches/step")
        print(f"  max memory allocated: first chunk (capture) "
              f"{graph_peak / 2**20:.1f} MiB ({(graph_peak - base) / 2**20:.1f}"
              f" MiB above the {base / 2**20:.1f} MiB before it); eager steps "
              f"{eager_peak / 2**20:.1f} MiB")
        out["chunk"] = dict(graph, chunk=N, ms_per_step=ms_chunked,
                            ms_per_step_no_diagnostics=ms_bench_form,
                            event_device_ms_per_step=ev_ms,
                            peak_bytes=graph_peak, bytes_before=base,
                            captures=graphs.captures,
                            replays=graphs.replays)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
