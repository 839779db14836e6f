#!/usr/bin/env python3
"""Where K4, the batched tridiagonal kernel (csrc/tridiag.cu), spends its
time on the card, on the two systems of the direct Helmholtz step at the
bench shape (32x128x256 f32, seeded developed flow, `helmholtz solver =
direct`): momentum (rhs (32, 3, 128, 2, 129), m = 99 072 systems) and
temperature (rhs (32, 1, 128, 2, 129), m = 33 024).

    python3 scripts/probe_k4.py

Prints, for each system:
  * the wrapper's time a call (diagnostics.device_time.time_ms: mean
    device time of one call over 50 back-to-back calls);
  * from torch.profiler over 20 calls: the device time and launches a
    call of the kernel alone, and of every other kernel the wrapper
    launches (copies of operands);
  * achieved bytes/s over the kernel's device time, against the operands
    as passed (ops.tridiag.values_moved: a broadcast axis counts once)
    and against the four operands materialized to (n, m) and x;
  * where the wrapper offers them (`block`, `pair`), its time under other
    launch plans: threads a block, and a real/imaginary pair solved with
    one reciprocal a row against the plain version's two divisions;
and for every kernel of csrc/tridiag.cu, ptxas's registers and static
shared memory; the blocks an SM holds of the launched kernel, from the
library's occupancy query where it has one (dynamic shared memory
included), else from ptxas by the occupancy rules of sm_90 (65,536
registers an SM allocated 256 a warp, 64 warps, 32 blocks, 228 KB of
shared memory less 1 KB a block).
The last line of standard output is one JSON object with these numbers.
Runs on the package beside it; needs one CUDA card, exits non-zero
without one.
"""

import ctypes
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_BYTES_PER_S = 3.35e12


def blocks_per_sm(regs, smem, threads):
    """Resident blocks an SM at `threads` a block (sm_90 occupancy)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if regs else 32
    by_smem = (233472 // (smem + 1024)) if smem else 32
    return min(by_regs, by_smem, 64 // warps, 32)


def device_kernels(fn, calls=20):
    """{kernel name: (device ms a call, launches a call)} over `calls`
    calls of fn, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        if t_us > 0:
            out[e.key] = (t_us / 1e3 / calls, e.count / calls)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k4: needs a CUDA card", file=sys.stderr)
        return 1
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl
    from dycoreplanet_tpu_torch.ops import tridiag as k4

    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {name}, {sms} SMs", flush=True)
    # a fresh build, so that ptxas's report is at hand
    lib = kl.lib_path("tridiag.cu")
    if os.path.exists(lib):
        os.remove(lib)
    kl.build_all()
    ptxas = kl.ptxas_summary("tridiag.cu")

    p = bench_params(BENCH_SHAPE)
    p.numerics.helmholtz_solver = "direct"
    m = BoussinesqModel(p, device="cuda")
    s = seed_developed_flow(m)
    rhs_u, T_adv = m._forcing(s.u, s.u_faces, s.T, s.p, BENCH_DT)
    coef = m._scalar(m.dtype.type(BENCH_DT) * m.dtype.type(m.one_over_Re))
    kT = m._scalar(m.dtype.type(BENCH_DT) * m.dtype.type(m.one_over_Pe))
    systems = {
        "momentum": m.helmholtz_direct.systems(m._vol_t[None] * rhs_u, coef),
        "temperature": m.temperature_direct.systems(
            (m._vol_t * T_adv)[None], kT)}
    tk = m._tridiag
    plans = hasattr(tk, "block") and hasattr(tk, "pair")
    report = {"device": name, "sms": sms, "ptxas": ptxas, "systems": {}}
    for what, sys4 in systems.items():
        rhs = sys4[3]
        n, mm = rhs.shape[0], rhs[0].numel()
        item = rhs.element_size()
        run = lambda: tk(*sys4)  # noqa: E731
        wrapper_ms = time_ms(run)
        kern = device_kernels(run)
        k_ms = sum(v[0] for k, v in kern.items() if "thomas" in k)
        others = {k: v for k, v in kern.items() if "thomas" not in k}
        passed = k4.values_moved(*sys4) * item
        materialized = 5 * n * mm * item
        if plans:
            lay = k4.layout(*sys4, pair=tk.pair)
            cols = lay.cols
            block, staged = tk.plan(lay, rhs.device)
            # the launched kernel's, with its dynamic shared memory
            lib = kl.library("tridiag.cu")
            occ = ctypes.c_int(0)
            kl.check(getattr(lib, f"dp_tridiag_{kl.suffix(rhs.dtype)}"
                                  "_occupancy")(
                n, lay.pair, int(lay.row_coefficients), block,
                ctypes.byref(occ)), "occupancy query")
            resident = {"launched kernel": occ.value}
        else:                      # one thread a system, 256 a block
            cols, block, staged = mm, 256, None
            resident = {r["kernel"]: blocks_per_sm(
                r["registers"], r["smem_bytes"], block) for r in ptxas}
        row = {"n": n, "m": mm, "wrapper_ms": wrapper_ms, "kernel_ms": k_ms,
               "other_kernels": others,
               "bytes_as_passed": passed, "bytes_materialized": materialized,
               "threads": cols, "block": block, "staged": staged,
               "blocks": math.ceil(cols / block), "blocks_per_sm": resident}
        print(f"{what} (n {n}, m {mm}): wrapper {wrapper_ms:.4f} ms a call; "
              f"kernel {k_ms:.4f} ms, {cols} threads in "
              f"{row['blocks']} blocks of {block} "
              f"({row['blocks'] / sms:.2f} an SM; resident an SM: "
              f"{resident})", flush=True)
        for k, (ms, cnt) in sorted(others.items(), key=lambda kv: -kv[1][0]):
            print(f"  other kernel: {ms:.4f} ms, {cnt:.1f} a call: "
                  f"{k[:100]}", flush=True)
        for label, b in (("as passed", passed),
                         ("materialized to (n, m)", materialized)):
            rate = b / (k_ms * 1e-3) if k_ms > 0 else float("nan")
            print(f"  bytes {label}: {b / 1e6:.2f} MB, bound "
                  f"{b / PEAK_BYTES_PER_S * 1e6:.2f} us, achieved "
                  f"{rate / 1e9:.1f} GB/s ({rate / PEAK_BYTES_PER_S:.1%} of "
                  f"3.35 TB/s)", flush=True)
        if plans:
            times = {}
            saved = tk.block, tk.pair
            for pair in (True, False):
                for blk in (32, 64, 128, 256):
                    tk.block, tk.pair = blk, pair
                    times[f"pair={pair} block={blk}"] = time_ms(run)
            tk.block, tk.pair = saved
            row["plans_ms"] = times
            for k, v in times.items():
                print(f"  plan {k}: {v:.4f} ms", flush=True)
        report["systems"][what] = row
    for r in ptxas:
        print(f"ptxas {r['kernel']}: {r['registers']} registers, "
              f"{r['stack_bytes']} bytes stack frame, {r['spill_stores']}/"
              f"{r['spill_loads']} bytes spill stores/loads, "
              f"{r['smem_bytes']} bytes static smem", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
