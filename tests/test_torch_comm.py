"""The mesh's communication ledger (parallel/comm_analysis.py) against
the contracts of the JAX package's tests/test_collectives.py, in f64 on
the CPU (the shards take the plain versions there):

  * every sharded fast diagonalization, direct Helmholtz solve and the
    spectral CG moves exactly one field-sized all-reduce a solve and
    nothing else (``test_sharded_fastdiag_poisson_psum_only``);
  * the default step on 2 and 8 shards at fixed per-shard work keeps
    ``test_collective_byte_volume_bounds``: all-gather <= one per-shard
    field, all-reduce and collective-permute <= 16 each, and per-device
    bytes that grow from 2 to 8 shards by no more than its factors;
  * the ``poisson solver = mg`` mesh step moves no all-to-all and no
    all-gather (``test_mg_poisson_sharded_collectives``);
  * the ledger's rules: executed ops (a sharded CG's inner products once
    an iteration), nothing outside ``counting``, nested blocks apart, a
    permute that stays on its shard not counted, a gather counted for
    its largest destination.

The port's counts are of executed ops, where the JAX counts are of HLO
instructions (a loop body once), so the Krylov paths are held per
iteration, not to the JAX count limits.
"""

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import BoussinesqModel, make_model
from dycoreplanet_tpu_torch.models.presets import stretched_shell
from dycoreplanet_tpu_torch.parallel import comm_analysis as comm
from dycoreplanet_tpu_torch.parallel import halo
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_field, shard_state)
from dycoreplanet_tpu_torch.parallel.sharded_step import ShardedStep
from dycoreplanet_tpu_torch.solvers.cg import cg, mesh_dot
from dycoreplanet_tpu_torch.solvers.helmholtz import (
    make_sharded_helmholtz_solver)
from dycoreplanet_tpu_torch.solvers.spectral import (
    make_poisson_solver, make_sharded_poisson_solver)
from tests.test_torch_kernels import _configure
from tests.test_torch_sharded_annulus import params

PER_SHARD = (8, 16, 32)
F64 = 8


def _shell(shape, **numerics):
    p = _configure(Parameters.from_text(""), "float64", shape)
    for k, v in numerics.items():
        setattr(p.numerics, k, v)
    return BoussinesqModel(p, device="cpu")


def _model(kind):
    """A model of ``kind`` (with the direct Helmholtz solves but on the
    slab, which has none in either package) and its mesh's shard
    count."""
    direct = {} if kind == "slab" else {"helmholtz_solver": "direct"}
    if kind == "shell":
        return _shell((8, 8, 16), **direct), 4
    return make_model(params(Parameters, kind, **direct), device="cpu"), {
        "annulus": 8, "box": 4, "slab": 4}[kind]


def _solve_case(case):
    """(the sharded solve of a seeded rhs, the values the one sum must
    carry, the right-hand side's cells)."""
    kind, which = case.split("-")
    if kind == "stretched":
        geo = stretched_shell((8, 16, 32))
        base = make_poisson_solver(geo, dtype=np.float64, rtol=1e-8,
                                   maxiter=100)
        mesh = build_mesh(geo, ["cpu"] * 4)
        solver = make_sharded_poisson_solver(base, mesh)
        nr, nlat, nlon = geo.cell_shape
        n_c, size = 1, nr * nlat * 2 * (nlon // 2 + 1)
    else:
        m, n = _model(kind)
        geo = m.geo
        mesh = build_mesh(geo, ["cpu"] * n)
        if which == "p":
            solver = make_sharded_poisson_solver(m.poisson_spectral, mesh)
            n_c = 1
        else:
            base = getattr(m, {"u": "helmholtz_direct",
                               "T": "temperature_direct"}[which])
            solver = make_sharded_helmholtz_solver(base, mesh)
            n_c = geo.dim if which == "u" else 1
        shape = list(geo.cell_shape)
        for ax in range(1, geo.dim):
            if ax == 1 and kind == "shell":
                continue                     # the lat rows: V, no DFT
            shape[ax] = 2 * (shape[ax] // 2 + 1)
        size = n_c * int(np.prod(shape))
    b = np.random.default_rng(5).standard_normal((n_c,) + geo.cell_shape)
    b -= b.mean()
    rhs = shard_field(torch.as_tensor(b if which in "uT" else b[0]), mesh)
    call = ((lambda: solver.solve(rhs, 0.25)) if which in "uT"
            else (lambda: solver.solve(rhs)))
    return call, size, int(np.prod(geo.cell_shape)) * n_c


@pytest.mark.parametrize("case", [
    "shell-p", "annulus-p", "box-p", "slab-p", "stretched-p",
    "shell-u", "shell-T", "annulus-u", "annulus-T", "box-u", "box-T"])
def test_sharded_solve_is_one_field_sized_all_reduce(case):
    """Each sharded solve's only collective is THE solver all-reduce: one
    op, whose payload is the right-hand side's real-DFT coefficients
    (the fields' cells, every DFT axis n + 2 long) in f64; no all-gather,
    no all-to-all, no permute."""
    call, size, cells = _solve_case(case)
    with comm.counting() as ledger:
        call()
    s = ledger.summary()
    assert s["all-reduce"] == {"count": 1, "bytes": F64 * size}, s
    assert cells <= size <= 1.6 * cells
    for op in ("all-gather", "all-to-all", "collective-permute",
               "reduce-scatter"):
        assert s[op] == {"count": 0, "bytes": 0}, (op, s)


def _default_step_summaries():
    """The default step's ledger on 2 and 8 shards at PER_SHARD cells a
    shard (test_collective_byte_volume_bounds' meshes: (1, 2) and (2,
    4))."""
    out = {}
    for n, mul in ((2, (1, 1, 2)), (8, (1, 2, 4))):
        m = _shell(tuple(s * k for s, k in zip(PER_SHARD, mul)))
        m.prepare_sharded(build_mesh(m.geo, ["cpu"] * n))
        assert m._mesh.mesh.grid == {2: (1, 2), 8: (2, 4)}[n]
        assert m.sharded_kernels()["richardson"] == "pallas-sharded"
        s = shard_state(m.initial_state(), m.geo, m._mesh.mesh)
        out[n] = comm.step_comm_summary(m, s, 0.01)
    return out


def test_default_step_byte_volume_bounds():
    """test_collective_byte_volume_bounds on the port's executed ops, in
    units of one per-shard f64 field: all-gather <= 1, all-reduce <= 16
    (the Poisson solve's one spectral field, n_shards per-shard fields,
    and the scalar sums), collective-permute <= 16 (the ghost
    exchanges); per-device bytes from 2 to 8 shards grow by at most 3x
    (permute, all-to-all) and 8x (all-reduce: the spectral field grows
    with the machine), or stay under one field."""
    field = F64 * int(np.prod(PER_SHARD))
    res = _default_step_summaries()
    for n, s in res.items():
        assert s["all-gather"]["bytes"] <= field, (n, s)
        assert s["all-reduce"]["bytes"] <= 16 * field, (n, s)
        assert s["collective-permute"]["bytes"] <= 16 * field, (n, s)
        assert s["all-to-all"]["count"] == s["reduce-scatter"]["count"] == 0
        assert s["collective-permute"]["count"] > 0
    grow = {"collective-permute": 3, "all-to-all": 3, "all-reduce": 8}
    for op, factor in grow.items():
        b2, b8 = res[2][op]["bytes"], res[8][op]["bytes"]
        assert b8 <= max(factor * b2, field), (op, b2, b8)


def test_mg_step_moves_no_gather_or_transpose():
    """test_mg_poisson_sharded_collectives: the `poisson solver = mg` mesh
    step (the radial-line V-cycle on the shards, its CG capped at two
    iterations) moves its data by nearest-neighbour permutes: 0
    all-to-all, 0 all-gather."""
    m = _shell((8, 16, 32), poisson_solver="mg", max_cg_iters=2)
    m.prepare_sharded(build_mesh(m.geo, ["cpu"] * 4))
    s = shard_state(m.initial_state(), m.geo, m._mesh.mesh)
    out = comm.step_comm_summary(m, s, 0.01)
    assert out["all-to-all"]["bytes"] == out["all-gather"]["bytes"] == 0
    assert out["collective-permute"]["count"] > 0


def test_sharded_cg_inner_products_once_an_iteration():
    """Executed ops: the sharded CG on the Poisson operator makes three
    inner products before its loop and three an iteration (p.Ap, r.z,
    r.r), one all-reduce each, and the operator's halo exchange (a
    pad_block: four permutes, the pole's two half turns) once before the
    loop and once an iteration."""
    geo = t_factory.make_shell(8, 16, 32, 1.0, 3.0)
    m = _shell((8, 16, 32))
    mesh = build_mesh(geo, ["cpu"] * 4)
    ops = ShardedStep(geo, mesh)
    b = np.random.default_rng(2).standard_normal(geo.cell_shape)
    bs = shard_field(torch.as_tensor(b - b.mean()), mesh)
    with comm.counting() as ledger:
        res = cg(lambda x: -ops.weak_laplacian(x, m.p_specs), bs,
                 rtol=1e-6, maxiter=7, dot=mesh_dot(ops.total))
    s = ledger.summary()
    k = res.iterations
    assert k == 7
    assert s["all-reduce"]["count"] == 3 * (k + 1)
    assert s["all-reduce"]["bytes"] == 3 * (k + 1) * F64
    assert s["collective-permute"]["count"] == 6 * (k + 1)


def test_ledger_rules():
    """Nothing is recorded outside a counting block; an inner block's ops
    are not the outer one's; a ring of one shard and an exchange along a
    mesh axis of one shard move nothing; a gather made one destination
    at a time counts its largest destination."""
    geo = t_factory.make_shell(4, 8, 16, 1.0, 2.0)
    x = torch.arange(float(np.prod(geo.cell_shape)),
                     dtype=torch.float64).reshape(geo.cell_shape)
    mesh = build_mesh(geo, ["cpu"] * 2)             # (1, 2)
    xs = shard_field(x, mesh)
    halo.psum(xs, mesh)
    with comm.counting() as outer:
        halo.psum(xs, mesh)
        with comm.counting() as inner:
            halo.exchange_ghosts(xs, mesh, "lat", 1, periodic=False)
            halo.exchange_ghosts(xs, mesh, "lon", 2)
        halo.pmax(xs.map(torch.max), mesh)
        halo.windows(xs, mesh, {
            (0, b): (range(0, 8), np.asarray(cols))
            for b, cols in enumerate((range(0, 12), range(4, 12)))})
    s_in, s_out = inner.summary(), outer.summary()
    block = F64 * int(np.prod(geo.cell_shape)) // 2
    assert s_in["collective-permute"] == {"count": 2,
                                          "bytes": 2 * block // 8}
    assert s_in["all-reduce"]["count"] == 0
    assert s_out["collective-permute"]["count"] == 0
    assert s_out["all-reduce"] == {"count": 2, "bytes": block + F64}
    assert s_out["all-gather"] == {"count": 1, "bytes": F64 * 4 * 8 * 12}
    assert comm.active is None
