"""The comparison that decides ``correct``.

The program's answers are the states that the window's chunks returned
for a sample drawn from the seed: the first and the last chunk of one
segment, each ``chunk`` steps of ``BoussinesqModel.multi_step`` from the
seeded state as the window ran them (CUDA graph replays and the gate).
The reference steps the same seeded inputs in float64, after the
program's state is freed, and each answer is compared field by field:

  u, faces, p, T   max |program - reference| over the field, over the
                   reference's max |field| (the worst of the sample)
  diag             the chunk's packed diagnostics of its last step (cfl,
                   max |u|, T_min, T_max) against the reference's: each
                   |program - reference| over the reference's cfl, max |u|
                   and max(|T_min|, |T_max|)
  div              the packed max |div u| of the last step against the
                   reference's, over the reference's cfl (a divergence
                   and the cfl are both a speed over a cell's size)
  gate             the segment's chunks that the program's gate let pass
                   where the reference's verdict misses

Each number has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

from reference.model import Fields, Reference

NUMBERS = ("u", "faces", "p", "T", "diag", "div", "gate")
DIAG = ("cfl", "max_velocity", "T_min", "T_max", "div_norm")


class Answer(NamedTuple):
    """One chunk's answer: its state, the packed diagnostics of its last
    step in ``DIAG`` order, and its solver_ok."""
    fields: Fields
    diag: List[float]
    ok: float


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64."""
    want = want.to(torch.float64)
    got = got.to(device=want.device, dtype=torch.float64)
    scale = float(torch.max(torch.abs(want)))
    return float(torch.max(torch.abs(got - want))) / max(scale, 1e-300)


def field_gaps(got: Fields, want: Fields) -> Dict[str, float]:
    return {"u": rel_gap(got.u, want.u),
            "faces": max(rel_gap(g, w) for g, w in zip(got.u_faces,
                                                       want.u_faces)),
            "p": rel_gap(got.p, want.p), "T": rel_gap(got.T, want.T)}


def diag_gaps(got: Sequence[float], want: Sequence[float]) -> Dict[str,
                                                                  float]:
    """``diag`` and ``div`` of one chunk (``DIAG`` order on both sides)."""
    cfl, speed, t_min, t_max, div = (float(x) for x in want)
    t_scale = max(abs(t_min), abs(t_max))
    scales = (cfl, speed, t_scale, t_scale)
    gaps = [abs(float(g) - w) / max(sc, 1e-300)
            for g, w, sc in zip(got[:4], want[:4], scales)]
    return {"diag": max(gaps),
            "div": abs(float(got[4]) - div) / max(cfl, 1e-300)}


def run_chunk(ref, f: Fields, dt: float, chunk: int, strong: bool = False):
    """``chunk`` steps of ``ref``: (fields, the verdict over every step,
    the last step's diagnostics in ``DIAG`` order)."""
    ok = torch.ones((), dtype=torch.bool, device=ref.device)
    diag = {}
    for _ in range(chunk):
        f, ok_step, diag = ref.step(f, dt, strong=strong)
        ok = torch.logical_and(ok, ok_step)
    return f, bool(ok), [float(diag[k]) for k in DIAG if k in diag]


def reference_gaps(ref: Reference, inputs: Fields, dt: float, chunk: int,
                   answers: Dict[int, Answer],
                   redone: Sequence[bool]) -> Dict[str, float]:
    """Step ``ref`` from ``inputs`` through the segment's chunks up to the
    last sampled one, as the port's chunk gate (``multi_step``) ran them,
    and compare each answer {chunk index in the segment: Answer}.

    The gate: a fast chunk whose verdict misses is redone from its start
    with strong steps, and opens an escalation window of ``penalty``
    steps (8, doubling on each repeated miss) in which chunks go
    straight to strong steps; a clean fast chunk resets the penalty. The
    segment starts with no window open (the sampled segment is never the
    first, and the one before it ends in clean fast chunks). Where the
    program redid a fast chunk (``redone[j]``: its escalation counter
    moved) the reference redoes it too, whatever its own verdict: the
    float32 program's residuals carry round-off that the float64
    reference's do not, and a chunk redone with full CG is the more
    exact answer, so a miss of the program's is no fault. The ``gate``
    number counts the chunks that the program let pass on the fast path
    (or reported clean) where the reference's verdict misses."""
    f = Fields(*(x.to(device=ref.device, dtype=ref.dtype) if torch.is_tensor(x)
                 else tuple(t.to(device=ref.device, dtype=ref.dtype)
                            for t in x) for x in inputs))
    out = {k: 0.0 for k in NUMBERS}
    left, penalty = 0, 8
    for j in range(max(answers) + 1):
        escalated = left > 0
        new, ok, diag = run_chunk(ref, f, dt, chunk, strong=escalated)
        if not escalated and (redone[j] or not ok):
            out["gate"] += float(not ok and not redone[j])
            left, penalty = penalty, min(2 * penalty, 1024)
            new, ok, diag = run_chunk(ref, f, dt, chunk, strong=True)
            escalated = True
        elif not escalated:
            penalty = 8
        if escalated and ok:
            left = max(0, left - chunk)
        f = new
        if j in answers:
            got = answers[j]
            gaps = field_gaps(got.fields, f)
            if diag:
                gaps.update(diag_gaps(got.diag, diag))
            for k, v in gaps.items():
                # a NaN reads as infinitely far
                out[k] = max(out[k], v if v == v else math.inf)
            out["gate"] += float(got.ok >= 0.5 and not ok)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in NUMBERS]
