#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dycoreplanet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. the card: torch's device name, and nvidia-smi's name + power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. kernel checks at 32x128x256 f32 on a seeded developed flow: K2
     (forcing), K1 (Richardson + projection head), K3 (faces_div), each
     against its plain PyTorch version on the card, with errors, median
     CUDA-event times and the roofline bound;
  4. main path: BoussinesqModel.run, 20 gated steps at 32x128x256 f32
     with the bench opt-ins, after 2 warm-up steps — zero escalations,
     finite fields, small post-projection divergence, K2 and K1
     launched on every step, K3 never;
  5. escalated path: one step_strong from the same state — K2 and K3
     launch once, and the result agrees with the fast step;
  6. the CLI on data/aqua_planet_shell_test_3d-classic.prm;
  7. one JSON line with every kernel's numbers, then, last, the
     {"ok": true, "device": ...} line.
Imports neither JAX nor the JAX package. Needs one CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 20
# H100 SXM data-sheet peaks (see PERF.md): HBM bandwidth, f32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_cells, fields, ops_per_cell, itemsize=4):
    """Least time (ms) for the work: the larger of bytes/bandwidth and
    operations/peak f32 rate; and which of the two bounds it."""
    t_bytes = fields * n_cells * itemsize / PEAK_BYTES_PER_S
    t_ops = ops_per_cell * n_cells / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, rtol, atol):
    """max |got - want| over the outputs; fails beyond atol + rtol|want|."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        excess = float(torch.max(d - (atol + rtol * w.abs())))
        if excess > 0:
            fail(f"{name}: kernel and plain version disagree "
                 f"(max |diff| {float(d.max()):.3e}, rtol {rtol}, "
                 f"atol {atol:.3e})")
        err = max(err, float(d.max()))
    return err


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    try:
        import dycoreplanet_tpu_torch
        from dycoreplanet_tpu_torch.models import BoussinesqModel
        from dycoreplanet_tpu_torch.models.presets import (
            BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
        from dycoreplanet_tpu_torch.ops import forcing as k2
        from dycoreplanet_tpu_torch.ops import kernel_lib
        from dycoreplanet_tpu_torch.ops import projection as k3
        from dycoreplanet_tpu_torch.ops import richardson as k1
    except ImportError as exc:
        fail(f"the port's package is not importable next to this script "
             f"({exc})")
    pkg_dir = os.path.dirname(os.path.realpath(dycoreplanet_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != os.path.realpath(HERE):
        fail(f"the port's package was imported from {pkg_dir}, not from the "
             f"checkout beside this script ({HERE})")
    if "jax" in sys.modules or "dycoreplanet_tpu" in sys.modules:
        fail("the port imported JAX or the JAX package")

    # ---- 1. the card ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    phase(f"device {kind} (count {count})")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # ---- 2. build ------------------------------------------------------
    secs = kernel_lib.build_all()
    phase(f"built {len(kernel_lib.SOURCES)} kernel sources in {secs:.1f} s")
    for src, log in sorted(kernel_lib.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    # ---- 3. kernel checks ---------------------------------------------
    dev = torch.device("cuda")
    model = BoussinesqModel(bench_params(BENCH_SHAPE), device=dev)
    n_cells = model.geo.n_cells
    s0 = seed_developed_flow(model)
    dt = model._scalar(BENCH_DT)
    fk, rk, pk = model._forcing, model._richardson, model._proj
    report = []

    # K2: forcing + fused temperature transport
    args2 = (s0.u, s0.u_faces, s0.T, s0.p, dt)
    got = fk(*args2)
    want = fk.plain(*args2)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    err2 = compare("K2 forcing", got, want, 0.0, 1e-5 * scale)
    ms, pms = time_ms(lambda: fk(*args2)), time_ms(lambda: fk.plain(*args2))
    b_ms, b_by = bound(n_cells, k2.FIELDS_MOVED, k2.OPS_PER_CELL)
    phase(f"K2 forcing: max abs err {err2:.3e} (tol {1e-5 * scale:.3e} = "
          f"1e-5 x scale), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {b_ms * 1e3:.1f} us ({b_by})")
    report.append(dict(name="K2 forcing", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/forcing.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_stencil.py:373",
                       max_abs_err=err2, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None))

    # K1: Richardson solves + projection head, on the K2 outputs
    rhs_u, T_adv = got
    kT = model._scalar(model.dtype.type(dt)
                       * model.dtype.type(model.one_over_Pe))
    rhs_T = model._vol_t * T_adv + kT * model._T_lap_offset_t
    args1 = (rhs_u, rhs_T, s0.T, dt)
    g1 = rk(*args1)
    w1 = rk.plain(*args1)
    torch.cuda.synchronize()
    err1 = compare("K1 iterates/faces", (g1[0], g1[1]) + tuple(g1[2][:3]),
                   (w1[0], w1[1]) + tuple(w1[2][:3]), 2e-6, 2e-6)
    sc = float(w1[2][3].abs().max()) + 1e-30
    err1 = max(err1, compare("K1 rhs_phi", (g1[2][3],), (w1[2][3],), 1e-4,
                             2e-5 * sc))
    norms_k = [float(x) for x in g1[3]]
    norms_p = [float(x) for x in w1[3]]
    phase(f"K1 norms (rn_u, bn_u, rn_T, bn_T): kernel {norms_k}, "
          f"plain {norms_p}")
    ms, pms = time_ms(lambda: rk(*args1)), time_ms(lambda: rk.plain(*args1))
    b_ms, b_by = bound(n_cells, k1.FIELDS_MOVED,
                       k1.ops_per_cell(rk.iters_u, rk.iters_T))
    phase(f"K1 richardson: max abs err {err1:.3e} (iterates/faces rtol=atol"
          f"=2e-6, rhs_phi rtol 1e-4 atol 2e-5 x scale), kernel {ms:.4f} ms,"
          f" plain {pms:.4f} ms, bound {b_ms * 1e3:.1f} us ({b_by})")
    report.append(dict(name="K1 richardson", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/richardson.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_richardson.py:348",
                       max_abs_err=err1, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None))

    # K3: faces_div on the K1 iterate
    u_star = g1[0]
    g3 = pk.faces_div(u_star, dt)
    w3 = pk.plain(u_star, dt)
    torch.cuda.synchronize()
    err3 = compare("K3 faces", g3[:3], w3[:3], 2e-6, 2e-6)
    sc = float(w3[3].abs().max()) + 1e-30
    err3 = max(err3, compare("K3 rhs_raw", (g3[3],), (w3[3],), 1e-4,
                             2e-5 * sc))
    err3 = max(err3, compare("K3 sum", (g3[4] / n_cells,), (w3[4] / n_cells,),
                             1e-4, 2e-5 * sc))
    ms = time_ms(lambda: pk.faces_div(u_star, dt))
    pms = time_ms(lambda: pk.plain(u_star, dt))
    b_ms, b_by = bound(n_cells, k3.FIELDS_MOVED, k3.OPS_PER_CELL)
    phase(f"K3 faces_div: max abs err {err3:.3e} (faces rtol=atol=2e-6, "
          f"rhs rtol 1e-4 atol 2e-5 x scale), kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b_ms * 1e3:.1f} us ({b_by})")
    report.append(dict(name="K3 faces_div", route="cuda",
                       source="dycoreplanet_tpu_torch/csrc/projection.cu",
                       replaces="dycoreplanet_tpu/ops/pallas_stencil.py:842",
                       max_abs_err=err3, ms=ms, plain_ms=pms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None))

    # the optional float64 instantiations, at a small grid: the kernels
    # and their plain versions then differ only by reassociation
    m64 = BoussinesqModel(bench_params((8, 16, 32), dtype="float64"),
                          device=dev)
    s64 = seed_developed_flow(m64)
    a2 = (s64.u, s64.u_faces, s64.T, s64.p, BENCH_DT)
    e64 = compare("K2 f64", m64._forcing(*a2), m64._forcing.plain(*a2),
                  1e-12, 1e-12)
    a1 = (m64._forcing(*a2)[0], s64.T, s64.T, BENCH_DT)
    g, w = m64._richardson(*a1), m64._richardson.plain(*a1)
    e64 = max(e64, compare("K1 f64", (g[0], g[1]) + tuple(g[2]),
                           (w[0], w[1]) + tuple(w[2]), 1e-11, 1e-11))
    g, w = m64._proj.faces_div(s64.u, BENCH_DT), m64._proj.plain(s64.u,
                                                                 BENCH_DT)
    e64 = max(e64, compare("K3 f64", g[:4], w[:4], 1e-12, 1e-12))
    phase(f"f64 kernels at (8, 16, 32): max abs err {e64:.3e} "
          f"(tol 1e-12, K1 1e-11)")

    # ---- 4. main path --------------------------------------------------
    # two warm-up steps first: the first Poisson solve pays the BLAS
    # library's one-time set-up, which is not a per-step cost
    model.run(max_steps=2, state=s0)
    for k in model.kernels().values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_end, hist = model.run(max_steps=N_STEPS, state=s0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in model.kernels().items()}
    if len(hist) != N_STEPS:
        fail(f"main path ran {len(hist)} steps, expected {N_STEPS}")
    if model.escalations != 0:
        fail(f"main path escalated {model.escalations} time(s)")
    for x in (s_end.u, s_end.p, s_end.T) + tuple(s_end.u_faces):
        if not bool(torch.isfinite(x).all()):
            fail("main path produced non-finite fields")
    divs = [h["div_norm"] for h in hist]
    div_max = max(divs)
    if not div_max < 1e-4:
        fail(f"post-projection divergence {div_max:.3e} >= 1e-4")
    want_l = {"forcing": N_STEPS, "richardson": N_STEPS, "faces_div": 0}
    if launches != want_l:
        fail(f"main-path launches {launches}, expected {want_l}")
    ms_step = wall / N_STEPS * 1e3
    phase(f"main path: {N_STEPS} gated steps, 0 escalations, launches "
          f"{launches}, max|div u| first/last/max {divs[0]:.3e}/"
          f"{divs[-1]:.3e}/{div_max:.3e}, "
          f"max|u| {hist[-1]['max_velocity']:.4f}, {ms_step:.3f} ms/step "
          f"(host clock incl. the per-step diagnostics read), "
          f"{n_cells / (wall / N_STEPS):.4e} grid points/s")
    for r in report:
        r["launches"] = launches[r["name"].split()[1]]

    # ---- 5. escalated path --------------------------------------------
    s_fast, d_fast = model.step(s_end, BENCH_DT)
    before = {name: k.launches for name, k in model.kernels().items()}
    s_strong, d_strong = model.step_strong(s_end, BENCH_DT)
    torch.cuda.synchronize()
    after = {name: k.launches for name, k in model.kernels().items()}
    delta = {k: after[k] - before[k] for k in after}
    if delta != {"forcing": 1, "richardson": 0, "faces_div": 1}:
        fail(f"step_strong launches {delta}, expected forcing 1, "
             "faces_div 1, richardson 0")
    if not d_strong.solver_ok:
        fail("step_strong did not converge")
    rel = float((s_fast.u - s_strong.u).abs().max()
                / s_strong.u.abs().max())
    # fast (Richardson + direct Poisson) vs full CG: both meet the solver
    # tolerances, floored at 16 eps in f32; allow 100x that floor
    tol = 100 * 16 * float(torch.finfo(torch.float32).eps)
    if not rel <= tol:
        fail(f"step_strong vs fast step: rel |du| {rel:.3e} > {tol:.3e}")
    phase(f"escalated path: step_strong launches {delta}, poisson CG iters "
          f"{d_strong.poisson_iters}, rel |u_fast - u_strong| {rel:.3e} "
          f"(tol {tol:.3e})")

    # ---- 6. CLI --------------------------------------------------------
    cli = subprocess.run(
        [sys.executable, "-m", "dycoreplanet_tpu_torch", "-p",
         os.path.join("data", "aqua_planet_shell_test_3d-classic.prm"),
         "--max-steps", "3", "--no-output"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if cli.returncode != 0:
        fail(f"CLI rc {cli.returncode}:\n{cli.stdout[-2000:]}\n"
             f"{cli.stderr[-2000:]}")
    div_lines = [ln.strip() for ln in cli.stdout.splitlines()
                 if "Post-projection" in ln]
    phase(f"CLI rc 0 ({len(div_lines)} step(s); last: "
          f"{div_lines[-1] if div_lines else 'none'})")

    # ---- 7. report -----------------------------------------------------
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
