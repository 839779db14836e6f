"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the comparison, and the metrics by their readers.

The window is a closed loop of one caller, as a ``--chunk`` run of the
port drives it: ``model.multi_step(state, dt, chunk,
collect_diagnostics=False)`` back to back, each call one CUDA graph
replay and the gate's one host read (a chunk that misses the gate is
redone inside the call with full CG). Every ``segment`` steps the loop
starts again from the seeded state, so that every chunk does the same
work at a dt far inside the CFL limit. The window opens at the first
timed call and closes at the return of the last call that returned
before ``seconds`` had passed; only those chunks count.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from core import check, program, trace
from core.inputs import make_inputs
from core.spec import Cell, reader
from reference.model import WORKING, Fields, Reference, settings


class Run(NamedTuple):
    """What the metric readers read."""
    shape: tuple
    itemsize: int
    points: int                 # cells of the grid
    chunk_s: List[float]        # host seconds of each chunk of the window
    window_s: float
    steps: int                  # steps completed in the window
    setup_s: float
    peak_bytes: int
    escalations: int            # in the window and the traced window
    traced: Optional[trace.Window]
    traced_steps: int


def _host(f: Fields) -> Fields:
    return Fields(f.u.cpu(), tuple(t.cpu() for t in f.u_faces), f.p.cpu(),
                  f.T.cpu())


def sample_segment(seed: int, segments: int) -> int:
    """The segment whose first and last chunks are compared, from the
    seed: one of the ``segments`` after the first (the first follows the
    set-up's chunks, whose gate state it inherits)."""
    return 1 + int(np.random.default_rng([abs(int(seed)), 1]).integers(
        segments))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float,
             patch: Optional[Callable] = None) -> dict:
    """One run: the result line's fields, and ``check`` (the compared
    numbers and their limits). ``patch(model)`` may replace the model's
    parts (the fault tests)."""
    tr = cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)          # the context, then the count
        torch.cuda.reset_peak_memory_stats(dev)
    s = settings(cell.config, tr["grid"])
    wd = WORKING[s.working]
    grid = Reference(s, dev, dtype=wd, tables=False)
    inputs = make_inputs(grid, tr["seed_rule"], seed, wd)
    model = program.model(cell.config, tr, device=dev)
    if patch is not None:
        patch(model)
    s0 = program.state(inputs)
    dt, chunk = float(tr["dt"]), int(tr["chunk"])
    per_seg = int(tr["segment"]) // chunk
    want_seg = sample_segment(seed, int(tr["sample_segments"]))
    want = (0, per_seg - 1)

    # set-up: the chunk's graph captured and replayed
    for _ in range(2):
        model.multi_step(s0, dt, chunk, collect_diagnostics=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    loop = {"state": s0, "k": 0, "seg": 0}
    answers: Dict[int, check.Answer] = {}
    redone = [False] * per_seg

    def advance():
        """One chunk of the loop; its host seconds."""
        esc = model.escalations
        t0 = time.perf_counter()
        new, packed, _ = model.multi_step(loop["state"], dt, chunk,
                                          collect_diagnostics=False)
        t1 = time.perf_counter()
        if loop["seg"] == want_seg:
            redone[loop["k"]] = model.escalations > esc
            if loop["k"] in want:
                row = packed[0].tolist()
                answers[loop["k"]] = check.Answer(
                    _host(program.fields(new)), row[:len(check.DIAG)],
                    row[10])
        loop["k"] += 1
        if loop["k"] == per_seg:
            loop.update(state=s0, k=0, seg=loop["seg"] + 1)
        else:
            loop["state"] = new
        return t0, t1

    esc0 = model.escalations
    chunk_s: List[float] = []
    w0 = time.perf_counter()
    end = w0 + seconds
    w1 = w0
    while True:
        t0, t1 = advance()
        if t1 > end:
            break
        chunk_s.append(t1 - t0)
        w1 = t1
    window_s = w1 - w0
    # the sampled answers are due: drive the loop on (untimed) until the
    # sampled segment's last chunk has come back
    while want[-1] not in answers:
        advance()
    window = None
    n_traced = 0
    if traced:
        # the traced window starts at a segment's first chunk
        while loop["k"] != 0:
            advance()
        n_traced = int(tr["trace_chunks"])
        _, window = trace.profiled(
            lambda: [advance() for _ in range(n_traced)])
    escalations = model.escalations - esc0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del model, s0, loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = Reference(s, dev, dtype=torch.float64)
    numbers = check.reference_gaps(
        ref, inputs, dt, chunk, {k: answers[k] for k in want}, redone)
    del ref
    run = Run(shape=tuple(tr["grid"]), itemsize=torch.finfo(wd).bits // 8,
              points=math.prod(tr["grid"]), chunk_s=chunk_s,
              window_s=window_s, steps=chunk * len(chunk_s),
              setup_s=setup_s, peak_bytes=int(peak),
              escalations=escalations, traced=window,
              traced_steps=n_traced * chunk)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok = check.verdict(numbers, cell.limits)
    out = {"correct": ok, "attempted": len(chunk_s),
           "failed": 0 if ok else len(want), "metrics": metrics,
           "numbers": numbers, "run": run,
           "redone": [k for k, r in enumerate(redone) if r]}
    if window is not None:
        out["busy_s"] = trace.busy_us(window.kernels, window.start_us,
                                      window.end_us) / 1e6
        out["window_s"] = window.seconds
        out["breakdown"] = {"device_ops": trace.device_ops(window),
                            "idle_gaps": trace.gaps_by_host(window)}
    return out
