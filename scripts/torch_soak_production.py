#!/usr/bin/env python3
"""Production soak of the port: the counterpart of
scripts/soak_production.py for dycoreplanet_tpu_torch.

The reference's production configuration (data/aqua_planet.prm, full
physical constants) at 64 x 2048, or with ``--scale3d`` the 3D shell at
32 x 128 x 256 on the projection fast path, run for ``--steps`` steps in
``multi_step`` chunks of ``--chunk``: dt 0.002 for the first chunk, the
reference's adaptive CFL dt inside every later chunk. Halfway it saves a
checkpoint (dt and the gate's state in its metadata), then reloads it
(the round trip bitwise), resumes the second half and requires the
final state bitwise the first run's. The CFL / T-range trajectory goes
to stderr, which chunks ran as CUDA graph replays to a line of stdout,
and the JAX script's JSON summary to the last line; the exit code is 0
when the summary is ok.

    python scripts/torch_soak_production.py [--steps 2000] [--chunk 100]
        [--scale3d] [--device cpu] [--shape 8x64] [--dtype float64]
        [--ckpt PATH.npz]

On the card unless ``--device`` names another; ``--shape`` and
``--dtype`` size the run down (tests, chip_smoke.py); ``--ckpt``: where
the checkpoint goes (default: a new temporary directory).

One departure from the JAX script: the JAX script resumes on the same
model object, so that an escalation window opened after the checkpoint
is still open at the resume and the resumed half can differ from the
first run; this script saves the gate's state (the window, the repeat
penalty, the escalation count) with the checkpoint and restores it
before the resume.

Imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PRM = os.path.join(ROOT, "data", "aqua_planet.prm")
# the fixed dt of the first chunk (a state at rest has no CFL dt)
FIRST_DT = 0.002


def soak_params(Parameters, scale3d=False, shape=None, dtype="float32"):
    """The soak's parameters on ``Parameters`` (either package's class):
    the JAX script's overrides of data/aqua_planet.prm line for line,
    then ``shape`` ((n_radial, n_lon) in 2D, (n_radial, n_lat, n_lon)
    with ``scale3d``) and ``dtype``."""
    p = Parameters.from_file(PRM)
    p.numerics.dtype = dtype
    # production 2D resolution: the prm's refinement-4 grid (16 x 192)
    # cannot resolve the reference ICs at the production planetary radii
    p.numerics.n_radial, p.numerics.n_lon = 64, 2048
    if scale3d:
        p.space_dimension = 3
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = (
            32, 128, 256)
        # the projection fast path with the bench's opt-ins
        p.use_schur_complement_solver = False
        p.numerics.poisson_precision = "high"
        p.numerics.poisson_tol = 1e-4
        p.numerics.momentum_fixed_iters = 1
        p.time_step = 0.002
    # widen the ICs so that the double-Gaussian anomaly is resolved at
    # the production grid (PARITY.md "Known quirks")
    p.numerics.ic_width_scale = 32.0 if scale3d else 4.0
    if shape is not None:
        shape = tuple(int(n) for n in shape)
        if scale3d:
            p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
        else:
            p.numerics.n_radial, p.numerics.n_lon = shape
    return p


def record_of(step, dt, row):
    """One chunk's trajectory record from its last packed row."""
    vals = np.asarray(row, dtype=np.float32)
    return {"step": step, "dt": float(dt),
            "cfl": float(vals[0]), "max_u": float(vals[1]),
            "T_min": float(vals[2]), "T_max": float(vals[3]),
            "div": float(vals[4]), "solver_ok": bool(vals[10] > 0.5)}


def _fields(state):
    return (state.u, state.p, state.T) + tuple(state.u_faces)


def same_state(a, b) -> bool:
    """Whether two States are bitwise equal (time and step included)."""
    import torch
    return (float(a.time) == float(b.time)
            and int(a.step_number) == int(b.step_number)
            and all(torch.equal(x, y) for x, y in zip(_fields(a),
                                                      _fields(b))))


def gate_state(model) -> dict:
    """The run loop's escalation state, which lives on the model."""
    return {"strong_steps_left": int(model._strong_steps_left),
            "fast_penalty_now": int(model._fast_penalty()),
            "escalations": int(model.escalations)}


def set_gate_state(model, gate: dict) -> None:
    model._strong_steps_left = gate["strong_steps_left"]
    model._fast_penalty_now = gate["fast_penalty_now"]
    model.escalations = gate["escalations"]


def soak(steps=2000, chunk=100, scale3d=False, device=None, shape=None,
         dtype="float32", ckpt=None, before_chunk=None):
    """The soak (module docstring). ``before_chunk(model, c)`` is called
    before chunk c of the first run and of the resume (the tests force a
    miss with it). Returns a dict: "summary" (the JAX script's keys; on a
    blow-up {"ok": False, "blew_up_at": record}), "records" (one a
    chunk), "final" and "resumed" (the two final States), "model",
    "replays" (the chunks, 1-based, that ran as graph replays),
    "escalations" and "gate" (the gate's state saved with the
    checkpoint)."""
    import torch

    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.io.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    from dycoreplanet_tpu_torch.models import make_model

    if steps % chunk != 0 or steps // chunk < 2:
        raise ValueError(f"--steps {steps} must be a multiple of --chunk "
                         f"{chunk}, two chunks at the least")
    n_chunks = steps // chunk
    mid = n_chunks // 2
    model = make_model(soak_params(Parameters, scale3d, shape, dtype),
                       device=device)
    dev = model.device
    tmp = None
    if ckpt is None:
        tmp = tempfile.TemporaryDirectory()
        ckpt = os.path.join(tmp.name, "soak_ckpt.npz")
    cells = int(np.prod(model.geo.cell_shape))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def replays():
        g = model.chunk_graphs
        return 0 if g is None else g.replays

    def one_chunk(c, state, dt):
        if before_chunk is not None:
            before_chunk(model, c)
        before = replays()
        # dt 0.002 for the first chunk, then the adaptive CFL dt
        state, packed, dt = model.multi_step(
            state, dt, chunk, collect_diagnostics=False, adaptive=c > 0)
        return state, packed.cpu().numpy()[-1], dt, replays() > before

    try:
        state = model.initial_state()
        dt = model._scalar(FIRST_DT)
        records, replayed = [], []
        mid_state = mid_dt = gate = None
        sync()
        t0 = time.perf_counter()
        for c in range(n_chunks):
            state, row, dt, replay = one_chunk(c, state, dt)
            records.append(record_of((c + 1) * chunk, dt, row))
            if replay:
                replayed.append(c + 1)
            if not np.isfinite(row[1]):
                return {"summary": {"ok": False,
                                    "blew_up_at": records[-1]},
                        "records": records, "model": model,
                        "replays": replayed,
                        "escalations": model.escalations}
            if c + 1 == mid:
                gate = gate_state(model)
                save_checkpoint(ckpt, state, metadata={
                    "chunk": c + 1, "dt": dt, "gate": gate})
                mid_state, mid_dt = state, dt
        sync()
        elapsed = time.perf_counter() - t0
        final_a = state
        escalations = model.escalations

        # the bitwise resume: reload the checkpoint (dt and the gate's
        # state in its metadata) and run the second half again
        state_b, meta = load_checkpoint(ckpt, dev)
        dt_b = meta["dt"]
        if mid_dt != dt_b:
            raise RuntimeError(f"dt not round-tripped: {mid_dt!r} saved, "
                               f"{dt_b!r} read")
        if not same_state(mid_state, state_b):
            raise RuntimeError("checkpoint round-trip not bitwise")
        set_gate_state(model, meta["gate"])
        for c in range(mid, n_chunks):
            state_b, _, dt_b, _ = one_chunk(c, state_b, dt_b)
        bitwise = same_state(final_a, state_b)
    finally:
        if tmp is not None:
            tmp.cleanup()

    summary = {
        "ok": bool(records[-1]["solver_ok"]) and bitwise,
        "config": ("aqua_planet.prm"
                   + (f" (3D shell {'x'.join(map(str, model.geo.cell_shape))})"
                      if scale3d else "")),
        "grid": list(model.geo.cell_shape),
        "steps": steps,
        "steps_per_sec": float(f"{steps / elapsed:.5g}"),
        "points_per_sec": float(f"{cells * steps / elapsed:.5g}"),
        "bitwise_resume": bitwise,
        "cfl_range": [min(r["cfl"] for r in records),
                      max(r["cfl"] for r in records)],
        "T_range_final": [records[-1]["T_min"], records[-1]["T_max"]],
        "max_u_final": records[-1]["max_u"],
        "dt_final": records[-1]["dt"],
        "div_final": records[-1]["div"],
        "trajectory_every": chunk,
    }
    return {"summary": summary, "records": records, "final": final_a,
            "resumed": state_b, "model": model, "replays": replayed,
            "escalations": escalations, "gate": gate}


def _shape(text):
    return tuple(int(n) for n in text.lower().split("x"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--scale3d", action="store_true",
                    help="3D shell at the bench grid instead of the 2D "
                         "production annulus")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; cpu for the plain "
                         "versions")
    ap.add_argument("--shape", type=_shape, default=None,
                    help="RxL (2D) or RxLATxLON (3D); default the "
                         "production grid")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64", "bfloat16"))
    ap.add_argument("--ckpt", default=None,
                    help="the checkpoint's path (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)
    out = soak(args.steps, args.chunk, args.scale3d, args.device,
               args.shape, args.dtype, args.ckpt)
    summary, records = out["summary"], out["records"]
    n_chunks = args.steps // args.chunk
    print(f"soak: chunks {out['replays']} of {n_chunks} ran as CUDA graph "
          f"replays, the rest eagerly; {out['escalations']} escalation(s); "
          f"device {out['model'].device}", flush=True)
    print(json.dumps(summary), flush=True)
    if "blew_up_at" in summary:
        return 1
    for r in records[:: max(1, len(records) // 10)]:
        print(f"  step {r['step']:6d}: cfl={r['cfl']:.4f} "
              f"max|u|={r['max_u']:.4f} T=[{r['T_min']:.3f},"
              f"{r['T_max']:.3f}] div={r['div']:.2e}", file=sys.stderr)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
