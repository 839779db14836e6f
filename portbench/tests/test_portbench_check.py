"""The comparison that decides ``correct``, driven on the CPU at a small
grid: the harness's look for a card skipped (``run_cell`` on "cpu"),
the port's plain path as the program. A sound run is correct; the
control (the reference in float32 with TF32 products) fails the cell's
limits; and a run whose timed path is broken underneath comes out not
correct: a chunk that returns its state unchanged, an answer altered
where it is produced, and its packed diagnostics altered."""

import time

import pytest
import torch

import calibrate
from core import check, spec
from core.cellrun import run_cell
from core.inputs import make_inputs
from reference.model import Reference, settings

# a small grid of each configuration, and the run's segment: two chunks
SMALL = {"shell-classic": [8, 16, 32], "annulus-test2d": [16, 192]}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(name):
    c = spec.cell(name)
    grid = SMALL[c.config["name"]]
    return c._replace(traffic=dict(c.traffic, grid=grid, segment=40,
                                   sample_segments=1))


def run(cell, patch=None):
    torch.set_num_threads(2)
    return run_cell(cell, 2 ** 31 + 77, 0.5, False, "cpu",
                    time.perf_counter(), patch=patch)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(small(name))
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert {"points_per_s", "chunk_ms_p95", "setup_s"} <= set(out["metrics"])


def control_numbers(cell, device):
    tr = cell.traffic
    s = settings(cell.config, tr["grid"])
    dev = torch.device(device)
    grid = Reference(s, dev, dtype=torch.float32, tables=False)
    inputs = make_inputs(grid, tr["seed_rule"], 12345, torch.float32)
    answers, redone = calibrate.control_answers(s, dev, inputs, tr)
    return check.reference_gaps(Reference(s, dev), inputs, tr["dt"],
                                tr["chunk"], answers, redone)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = small(name)
    numbers = control_numbers(cell, "cpu")
    assert not check.verdict(numbers, cell.limits), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cell_size(card, name):
    cell = spec.cell(name)
    numbers = control_numbers(cell, "cuda")
    assert not check.verdict(numbers, cell.limits), numbers


def frozen(model):
    """multi_step returns the state it was given, as if no step ran."""
    step = model.multi_step

    def multi_step(state, dt, n, **kw):
        _, packed, dt_out = step(state, dt, n, **kw)
        return state, packed, dt_out
    model.multi_step = multi_step


def altered(model):
    """multi_step's answer altered where it is produced: one cell of T
    off by 1% of the field's largest value."""
    step = model.multi_step

    def multi_step(state, dt, n, **kw):
        new, packed, dt_out = step(state, dt, n, **kw)
        T = new.T.clone()
        T.view(-1)[T.numel() // 3] += 0.01 * float(T.abs().max())
        return new._replace(T=T), packed, dt_out
    model.multi_step = multi_step


def diag_altered(model):
    """The packed diagnostics altered where they are produced: the last
    step's max |u| off by 1%."""
    step = model.multi_step

    def multi_step(state, dt, n, **kw):
        new, packed, dt_out = step(state, dt, n, **kw)
        packed = packed.clone()
        packed[-1, 1] *= 1.01
        return new, packed, dt_out
    model.multi_step = multi_step


@pytest.mark.parametrize("fault", [frozen, altered, diag_altered],
                         ids=["unchanged", "altered", "diag_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    out = run(small(name), patch=fault)
    assert not out["correct"], out["numbers"]
    assert out["failed"] > 0


@pytest.mark.parametrize("strong", [False, True], ids=["fast", "strong"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_plain_path(name, strong):
    """Three steps of the reference against the port's plain path (its
    CPU step, ``step`` or ``step_strong``): the fast step, both computed
    in float32, to round-off; the strong step with the configuration
    run in float64 on both sides (the float32 program's CG stops at its
    clamped tolerance, which float64 does not share), to round-off."""
    import json

    from core import program

    cell = small(name)
    tr = cell.traffic
    config = json.loads(json.dumps(cell.config))
    if strong:
        config["numerics"]["dtype"] = "float64"
    dtype = torch.float64 if strong else torch.float32
    s = settings(config, tr["grid"])
    grid = Reference(s, "cpu", dtype=dtype, tables=False)
    inputs = make_inputs(grid, tr["seed_rule"], 99, dtype)
    model = program.model(config, tr, device="cpu")
    state = program.state(inputs)
    ref = Reference(s, "cpu", dtype=dtype)
    f = inputs
    for _ in range(3):
        step = model.step_strong if strong else model.step
        state, diag = step(state, tr["dt"])
        f, ok, _ = ref.step(f, tr["dt"], strong=strong)
        assert bool(ok) == bool(diag.solver_ok)
    gaps = check.field_gaps(program.fields(state), f)
    assert max(gaps.values()) < (1e-12 if strong else 1e-6), gaps


class Scripted:
    """A stand-in reference whose fast steps add 1 to u and strong steps
    2, and whose fast verdicts follow a script of chunks that miss."""

    device, dtype = torch.device("cpu"), torch.float64

    def __init__(self, chunk, misses):
        self.chunk, self.misses, self.n = chunk, set(misses), 0

    def step(self, f, dt, strong=False):
        j = self.n // self.chunk
        self.n += 1
        ok = strong or j not in self.misses
        u = f.u + (2.0 if strong else 1.0)
        return f._replace(u=u), torch.tensor(ok), {}


def fields(u):
    from reference.model import Fields

    z = torch.zeros(2, dtype=torch.float64)
    return Fields(torch.full((2,), float(u), dtype=torch.float64), (z, z),
                  z + 1, z + 1)


@pytest.mark.parametrize("misses,redone,want_u,gate", [
    # no miss anywhere: two fast chunks of 2 steps
    ((), [False, False], 4, 0),
    # the reference misses chunk 0 and the program redid it: both strong,
    # then chunk 1 straight to strong (the window of 8 steps is open)
    ((0,), [True, False], 8, 0),
    # the program redid chunk 0 where the reference passes: it follows
    ((), [True, False], 8, 0),
    # the program let chunk 0 pass where the reference misses: a fault
    ((0,), [False, False], 8, 1),
])
def test_the_gate_is_followed(misses, redone, want_u, gate):
    """reference_gaps runs the chunks as the program's gate ran them."""
    chunk = 2
    ref = Scripted(chunk, misses)
    # the stepping stand-in counts fast tries too: misses index the
    # chunk attempts in order
    answers = {1: check.Answer(fields(want_u), [], 1.0)}
    out = check.reference_gaps(ref, fields(0), 0.1, chunk, answers, redone)
    assert out["u"] == 0.0
    assert out["gate"] == gate
