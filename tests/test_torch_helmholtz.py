"""K4 (the batched tridiagonal solve) and the direct shell Helmholtz
solver of the PyTorch port, on CPU, against the JAX package:

  * ``thomas_solve`` (K4's plain version, reached through the K4 wrapper
    on CPU tensors) against the JAX ``thomas_solve`` and the Pallas
    ``tridiag_pallas`` in interpret mode, on the random SPD systems of
    tests/test_pallas.py: 1e-12 in f64; rtol = atol = 1e-5 x the
    solution scale in f32 (the two recurrences round differently);
  * ``ShellHelmholtzDirect`` against the JAX one (``use_pallas=False``)
    on the same b and c, f64, to 1e-12 relative (the same formulas in
    float64; only the matrix products' summation order differs);
  * the port twins of tests/test_helmholtz.py ``TestShell``: the solve
    inverts (vol - c * weak_laplacian) to the JAX tests' tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.grid.factory import make_shell as j_make_shell
from dycoreplanet_tpu.ops import bc as j_bc
from dycoreplanet_tpu.ops.pallas_kernels import tridiag_pallas
from dycoreplanet_tpu.solvers.helmholtz import (
    ShellHelmholtzDirect as JHelmholtz)
from dycoreplanet_tpu.solvers.tridiag import thomas_solve as j_thomas
from dycoreplanet_tpu_torch.grid.factory import make_cuboid, make_shell
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve, values_moved
from dycoreplanet_tpu_torch.solvers.helmholtz import (
    ShellHelmholtzDirect, make_helmholtz_solver)
from dycoreplanet_tpu_torch.solvers.tridiag import thomas_solve

AS, NEU, PO, PF = BC.ANTISYM, BC.NEUMANN, BC.POLE, BC.POLE_FLIP
U_SPECS = [[BCSpec(AS, AS), BCSpec(PO, PO), None],
           [BCSpec(AS, NEU), BCSpec(PF, PF), None],
           [BCSpec(AS, NEU), BCSpec(PF, PF), None]]
T_SPECS = [[BCSpec(AS, NEU), BCSpec(PO, PO), None]]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _random_spd_tridiag(rng, n, batch):
    lower = -rng.rand(n, *batch)
    upper = -rng.rand(n, *batch)
    lower[0] = 0.0
    upper[-1] = 0.0
    diag = -(lower + upper) + 1.0 + rng.rand(n, *batch)
    return lower, diag, upper


# ---------------------------------------------------------------- K4
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,batch", [(8, (4,)), (32, (16, 10)), (5, (1,)),
                                     (16, (130,))])
def test_thomas_matches_jax_and_pallas(n, batch, dtype):
    rng = np.random.RandomState(0)
    arrs = [a.astype(dtype) for a in
            _random_spd_tridiag(rng, n, batch) + (rng.randn(n, *batch),)]
    k4 = TridiagSolve()
    got = _np(k4(*[torch.as_tensor(a) for a in arrs]))
    assert k4.launches == 0          # CPU tensors take the plain version
    want_scan = np.asarray(j_thomas(*[jnp.asarray(a) for a in arrs]))
    want_pallas = np.asarray(tridiag_pallas(*[jnp.asarray(a) for a in arrs],
                                            interpret=True))
    assert got.dtype == dtype and got.shape == (n,) + batch
    tol = (1e-12 if dtype == np.float64
           else 1e-5 * float(np.max(np.abs(want_scan))))
    for want in (want_scan, want_pallas):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_thomas_against_dense():
    rng = np.random.RandomState(1)
    n = 12
    lower, diag, upper = _random_spd_tridiag(rng, n, (1,))
    rhs = rng.randn(n, 1)
    x = _np(thomas_solve(*[torch.as_tensor(a)
                           for a in (lower, diag, upper, rhs)]))
    A = (np.diag(diag[:, 0]) + np.diag(lower[1:, 0], -1)
         + np.diag(upper[:-1, 0], 1))
    np.testing.assert_allclose(x[:, 0], np.linalg.solve(A, rhs[:, 0]),
                               rtol=1e-10)


def test_wrapper_broadcasts_coefficients():
    """The contract of the JAX ``tridiag_solve``: coefficients broadcast
    against rhs, every trailing axis is batch."""
    rng = np.random.RandomState(2)
    n = 6
    low, diag, up = _random_spd_tridiag(rng, n, (1, 1))
    diag = diag + rng.rand(n, 3, 1)                    # (n, 3, 1)
    rhs = rng.randn(n, 3, 4)
    want = np.asarray(j_thomas(*[jnp.broadcast_to(jnp.asarray(a), rhs.shape)
                                 for a in (low, diag, up, rhs)]))
    got = TridiagSolve()(*[torch.as_tensor(a) for a in (low, diag, up,
                                                        rhs)])
    assert got.shape == rhs.shape
    np.testing.assert_allclose(_np(got), want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------- direct Helmholtz
@pytest.mark.parametrize("shape", [(4, 8, 16), (8, 16, 32)])
@pytest.mark.parametrize("field", ["momentum", "temperature"])
def test_shell_helmholtz_matches_jax(shape, field):
    nr, nlat, nlon = shape
    jgeo = j_make_shell(nr, nlat, nlon, 1.0, 3.0)
    geo = make_shell(nr, nlat, nlon, 1.0, 3.0)
    if field == "momentum":
        J = j_bc.BC
        j_specs = [j_bc.BCSpec(J.ANTISYM, J.ANTISYM),
                   j_bc.BCSpec(J.ANTISYM, J.NEUMANN),
                   j_bc.BCSpec(J.ANTISYM, J.NEUMANN)]
        specs = [s[0] for s in U_SPECS]
        c = 0.037
    else:
        j_specs = [j_bc.BCSpec(j_bc.BC.ANTISYM, j_bc.BC.NEUMANN)]
        specs = [T_SPECS[0][0]]
        c = 2.1e-3
    jsol = JHelmholtz(jgeo, j_specs, dtype=np.float64, use_pallas=False)
    sol = ShellHelmholtzDirect(geo, specs, dtype=np.float64)
    for name in ("_F", "_G", "_V", "_v", "_trd", "_lam", "_low", "_up"):
        np.testing.assert_array_equal(getattr(sol, name),
                                      np.asarray(getattr(jsol, name)), name)
    b = np.random.default_rng(7).standard_normal((len(specs),) + shape)
    want = np.asarray(jsol.solve(jnp.asarray(b), c))
    got = _np(sol.solve(torch.as_tensor(b), c))
    assert float(np.max(np.abs(got - want))) <= \
        1e-12 * float(np.max(np.abs(want)))
    assert sol.tridiag.launches == 0


def test_values_moved_counts_operands_as_passed():
    """K4's traffic bound on the direct solver's systems: lower and upper
    hold one value a row, diag is broadcast over the real/imaginary axis
    (half of rhs), and x is rhs's size: rhs + x + diag + 2 n."""
    nr, nlat, nlon = 8, 16, 32
    sol = ShellHelmholtzDirect(make_shell(nr, nlat, nlon, 1.0, 3.0),
                               [s[0] for s in U_SPECS], dtype=np.float64)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, nr, nlat, nlon)))
    low, diag, up, rhs = sol.systems(b, 0.037)
    assert rhs.shape == (nr, 3, nlat, 2, nlon // 2 + 1)
    assert diag.numel() * 2 == rhs.numel()
    want = 2 * rhs.numel() + rhs.numel() // 2 + 2 * nr
    assert values_moved(low, diag, up, rhs) == want
    # a coefficient expanded to rhs's shape holds no more values
    assert values_moved(low.expand(rhs.shape), diag.expand(rhs.shape),
                        up, rhs) == want


def _check_exact(geo, specs_list, c, tol=1e-11):
    """Port twin of tests/test_helmholtz.py _check_exact."""
    sol = make_helmholtz_solver(geo, [s[0] for s in specs_list],
                                dtype=np.float64)
    vol = torch.as_tensor(np.broadcast_to(geo.vol, geo.cell_shape).copy())
    rng = np.random.RandomState(42)
    x_true = torch.as_tensor(rng.randn(len(specs_list), *geo.cell_shape))
    b = torch.stack([
        vol * x_true[i] - c * st.weak_laplacian(geo, x_true[i], specs_list[i])
        for i in range(len(specs_list))])
    err = float(torch.max(torch.abs(sol.solve(b, c) - x_true)))
    assert err < tol, err


class TestShell:
    def test_momentum_stack(self):
        _check_exact(make_shell(8, 16, 32, 1.0, 3.0), U_SPECS, 0.037)

    def test_temperature(self):
        _check_exact(make_shell(8, 16, 32, 1.0, 3.0), T_SPECS, 2.1e-3)

    def test_thin_production_shell(self):
        # aqua_planet radii regime: extreme aspect ratio
        _check_exact(make_shell(8, 24, 48, 637.1, 647.1), U_SPECS, 1e-4,
                     tol=1e-7)

    def test_several_coefficients_one_solver(self):
        """c enters only on the device side: one solver, many dt."""
        g = make_shell(4, 8, 16, 1.0, 2.0)
        sol = make_helmholtz_solver(g, [T_SPECS[0][0]], dtype=np.float64)
        vol = torch.as_tensor(np.broadcast_to(g.vol, g.cell_shape).copy())
        x_true = torch.as_tensor(np.random.RandomState(3).randn(
            1, *g.cell_shape))
        for c in (1e-4, 3.3e-2, 0.7):
            b = vol[None] * x_true - c * st.weak_laplacian(
                g, x_true[0], T_SPECS[0])[None]
            np.testing.assert_allclose(_np(sol.solve(b, c)), _np(x_true),
                                       atol=1e-11)


def test_other_geometries_not_ported():
    """Once a refusal: the cuboid's direct solver (a full fast
    diagonalization, no K4) is now ported, as the annulus's is
    (tests/test_torch_annulus.py). On 4 x 4 x 4 with the temperature's z
    rule it inverts (vol - c weak_laplacian) to 1e-11 (the JAX solver's
    parity: tests/test_torch_cuboid.py)."""
    g = make_cuboid(4, 4, 4)
    spec = BCSpec(AS, NEU)
    sol = make_helmholtz_solver(g, [spec], dtype=np.float64)
    vol = float(np.asarray(g.vol).flat[0])
    x_true = torch.as_tensor(np.random.RandomState(4).randn(1, 4, 4, 4))
    for c in (1e-4, 3.3e-2, 0.7):
        b = vol * x_true - c * st.weak_laplacian(
            g, x_true[0], [spec, None, None])[None]
        np.testing.assert_allclose(_np(sol.solve(b, c)), _np(x_true),
                                   atol=1e-11)
