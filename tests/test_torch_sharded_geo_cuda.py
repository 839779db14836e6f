"""The annulus's and the box's meshes on a CUDA card: K4 in the annulus
mesh's V-cycle layout (each phi shard's radial lines, its own (nr, no)
coefficients and residual) against K4's plain version, and one mesh step
of the annulus and of the box on the card against the same step on the
CPU, in f64; the sharded direct Helmholtz solves, the sharded spectral
CG and a direct shell mesh step on the card against the CPU, with K4's
launches (once a solve on one card). Imports neither JAX nor the JAX
package, so that it runs on a machine with a card and no JAX; it skips
without a card."""

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.factory import make_annulus
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    state_from_numpy, state_to_numpy)
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_field, shard_state, unshard_state)
from dycoreplanet_tpu_torch.solvers.multigrid import (
    PoissonMultigrid, ShardedPoissonMultigrid)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_k4_on_the_annulus_mesh_lines():
    """At 32 x 384 on 8 phi shards, f32 and f64: every level's shard
    operands as passed, nothing copied, K4 against its plain version
    (atol 1e-5 x scale in f32, 1e-12 in f64), one launch a shard a line
    solve in a V-cycle."""
    dev = _card()
    geo = make_annulus(32, 384, 1.0, 2.0)
    specs = [BCSpec(BC.NEUMANN, BC.NEUMANN), None]
    mesh = build_mesh(geo, [dev] * 8)
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tk = k4.TridiagSolve()
        mg = ShardedPoissonMultigrid(PoissonMultigrid(
            geo, specs, dtype=dtype, device=dev, tridiag=tk,
            line_axes_allowed=(0,)), mesh)
        gen = torch.Generator(device=dev).manual_seed(3)
        for level, op in enumerate(mg.ops):
            r = torch.randn(op.local, generator=gen, device=dev, dtype=dtype)
            ops = mg.shard_operands(level, (0, 7), r)
            assert k4.layout(*ops, pair=tk.pair).copied == ()
            want = tk.plain(*ops)
            got = tk(*ops)
            np.testing.assert_allclose(
                got.cpu().numpy(), want.cpu().numpy(), rtol=0,
                atol=rel * float(want.abs().max()))
        tk.launches = 0
        b = torch.randn(geo.cell_shape, generator=gen, device=dev,
                        dtype=dtype)
        mg(shard_field(b - b.mean(), mesh))
        assert tk.launches == 8 * mg.line_solves_per_cycle()
        assert tk.copies == 0


def _params(kind):
    p = Parameters.from_text("")
    p.numerics.dtype = "float64"
    if kind == "box":
        p.space_dimension = 3
        p.cuboid_geometry = True
        p.numerics.nx = p.numerics.ny = p.numerics.nz = 16
        p.physical_constants.expansion_coefficient = 0.2
        p.reference_quantities.temperature_ref = 3.0
    else:
        p.space_dimension = 2
        p.numerics.n_radial, p.numerics.n_lon = 16, 192
        p.physical_constants.R0 = 1.0
        p.physical_constants.atm_height = 2.0
        p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.physical_constants.__post_init__()
    p.reference_quantities.__post_init__()
    p.time_step = 0.01
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["annulus", "box"])
def test_cuda_mesh_step_matches_the_cpu(kind):
    """One f64 mesh step (8 shards) on the card against the CPU's mesh
    from the same state: equal iteration counts, each field within 1e-12
    of its scale."""
    dev = _card()
    cpu = BoussinesqModel(_params(kind), device="cpu")
    cpu.prepare_sharded(build_mesh(cpu.geo, ["cpu"] * 8))
    card = BoussinesqModel(_params(kind), device=dev)
    card.prepare_sharded(build_mesh(card.geo, [dev] * 8))
    s_cpu = cpu.run(max_steps=1)[0]
    s_card = shard_state(state_from_numpy(
        card, *state_to_numpy(unshard_state(s_cpu))), card.geo,
        card._mesh.mesh)
    c, dc = cpu.step(s_cpu, 0.01)
    g, dg = card.step(s_card, 0.01)
    assert (dg.poisson_iters, dg.temperature_iters) == \
        (dc.poisson_iters, dc.temperature_iters)
    gc, gg = unshard_state(c), unshard_state(g)
    for x, y in zip((gg.u, gg.p, gg.T), (gc.u, gc.p, gc.T)):
        assert float((x.cpu() - y).abs().max()) <= 1e-12 * float(
            y.abs().max())


def _direct(kind):
    """A small f64 model of ``kind`` with the direct Helmholtz solves:
    "shell" the flagship's physics at 8 x 16 x 32, else _params' annulus
    or box."""
    if kind == "shell":
        from dycoreplanet_tpu_torch.models.presets import bench_params
        p = bench_params((8, 16, 32), "float64")
    else:
        p = _params(kind)
    p.numerics.helmholtz_solver = "direct"
    return p


SHARDS = {"shell": 4, "annulus": 8, "box": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["shell", "annulus", "box"])
def test_cuda_sharded_helmholtz_matches_the_cpu(kind):
    """The sharded direct Helmholtz solves (momentum and temperature) on
    the card against the same on the CPU, f64, on a seeded stack of
    right-hand sides: within 1e-12 of the scale; K4 once a solve on the
    shell and the annulus (one card: the middle runs once), nothing
    copied; the box none."""
    from dycoreplanet_tpu_torch.solvers.helmholtz import (
        make_sharded_helmholtz_solver)
    from dycoreplanet_tpu_torch.parallel.mesh import unshard_field

    dev = _card()
    cpu = BoussinesqModel(_direct(kind), device="cpu")
    card = BoussinesqModel(_direct(kind), device=dev)
    n = SHARDS[kind]
    for attr, n_c in (("helmholtz_direct", cpu.geo.dim),
                      ("temperature_direct", 1)):
        b = np.random.default_rng(4).standard_normal(
            (n_c,) + cpu.geo.cell_shape)
        want = unshard_field(make_sharded_helmholtz_solver(
            getattr(cpu, attr), build_mesh(cpu.geo, ["cpu"] * n)).solve(
                shard_field(torch.as_tensor(b), build_mesh(
                    cpu.geo, ["cpu"] * n)), 0.3))
        tk = card._tridiag
        tk.launches = tk.copies = 0
        mesh = build_mesh(card.geo, [dev] * n)
        got = unshard_field(make_sharded_helmholtz_solver(
            getattr(card, attr), mesh).solve(shard_field(
                torch.as_tensor(b, device=dev), mesh), 0.3))
        assert float((got.cpu() - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
        assert tk.launches == (0 if kind == "box" else 1)
        assert tk.copies == 0


@pytest.mark.cuda
def test_cuda_sharded_spectral_cg_matches_the_cpu():
    """The sharded spectral CG on a stretched 8 x 16 x 32 shell (2 x 2),
    f64, tests/test_torch_spectral_direct.py's order-free right-hand side
    (the CPU generator's seed 19, rtol 1e-11): the card's count equal to
    the CPU's, the solution within 1e-12 of its scale; K4 the iterations
    + 1, nothing copied."""
    from dycoreplanet_tpu_torch.models.presets import stretched_shell
    from dycoreplanet_tpu_torch.parallel.mesh import unshard_field
    from dycoreplanet_tpu_torch.solvers import spectral

    dev = _card()
    geo = stretched_shell((8, 16, 32))
    gen = torch.Generator().manual_seed(19)
    b = torch.randn(geo.cell_shape, generator=gen, dtype=torch.float64)
    b = b - b.mean()
    out = {}
    for d in ("cpu", dev):
        base = spectral.ShellPoissonSpectral(
            geo, dtype=np.float64, rtol=1e-11, maxiter=300, device=d)
        mesh = build_mesh(geo, [d] * 4)
        x, its = spectral.make_sharded_poisson_solver(base, mesh).solve(
            shard_field(b.to(d), mesh))
        out[str(d)] = (unshard_field(x).cpu(), its, base.tridiag)
    (xc, ic, _), (xg, ig, tk) = out["cpu"], out[str(dev)]
    assert ig == ic > 0
    assert float((xg - xc).abs().max()) <= 1e-12 * float(xc.abs().max())
    assert tk.launches == ig + 1 and tk.copies == 0


@pytest.mark.cuda
def test_cuda_direct_shell_mesh_step_matches_the_cpu():
    """One f64 direct step of the shell's 2 x 2 mesh on the card against
    the CPU's from the same state: equal counts, each field within 1e-12
    of its scale, K4 twice (momentum, temperature), nothing copied."""
    dev = _card()
    cpu = BoussinesqModel(_direct("shell"), device="cpu")
    cpu.prepare_sharded(build_mesh(cpu.geo, ["cpu"] * 4))
    card = BoussinesqModel(_direct("shell"), device=dev)
    card.prepare_sharded(build_mesh(card.geo, [dev] * 4))
    s_cpu = cpu.run(max_steps=1)[0]
    s_card = shard_state(state_from_numpy(
        card, *state_to_numpy(unshard_state(s_cpu))), card.geo,
        card._mesh.mesh)
    card._tridiag.launches = 0
    c, dc = cpu.step(s_cpu, 0.01)
    g, dg = card.step(s_card, 0.01)
    assert card._tridiag.launches == 2 and card._tridiag.copies == 0
    assert (dg.poisson_iters, dg.temperature_iters) == \
        (dc.poisson_iters, dc.temperature_iters)
    gc, gg = unshard_state(c), unshard_state(g)
    for x, y in zip((gg.u, gg.p, gg.T), (gc.u, gc.p, gc.T)):
        assert float((x.cpu() - y).abs().max()) <= 1e-12 * float(
            y.abs().max())
