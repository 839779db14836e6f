"""The Poisson solvers that reach K4 off the model's paths, in the
PyTorch port against the JAX package, on CPU in float64 from numpy-seeded
right-hand sides: ``AnnulusPoissonDirect``, ``ShellPoissonDirect`` and
``ShellPoissonSpectral`` (the factory's solve for a shell whose radial
spacing is not uniform).

  * each direct solve as an exact inverse of -weak_laplacian (the JAX
    package's tests/test_spectral.py), and within 1e-10 of the JAX solve
    on the same b;
  * ``ShellPoissonSpectral``: its spectral operator against the JAX one
    to 1e-12, the CG iteration count equal to the JAX count on
    right-hand sides whose JAX count does not change with the order of
    its sums, the solution within 1e-10 of JAX's at rtol 1e-11 and both
    held to x_true; the direct solve against the spectral CG;
  * ``make_poisson_solver`` on a shell with stretched radial faces (the
    same Geometry arrays in both packages, presets.stretched_shell)
    builds ``ShellPoissonSpectral`` in both, with iterations and
    solutions as above, as does the model, which then runs no CUDA
    graph and steps the same through run and multi_step;
  * K4's description of each solver's operands: no copy, the pair axis
    where lower, diag and upper are broadcast across the real and
    imaginary parts (the annulus and the shell direct solves; one launch
    where the JAX package calls its tridiagonal solve twice), none for
    the spectral CG's radial lines (lower varies along lat).
The kernel's arithmetic is held against its plain version on the card
(chip_smoke.py phase 11)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.grid import geometry as j_geometry
from dycoreplanet_tpu.solvers import spectral as j_spec
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.presets import stretched_shell
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.parallel.mesh import Mesh
from dycoreplanet_tpu_torch.solvers import spectral as t_spec

# the JAX CG's module (its package's solvers/__init__ exports the
# function under the same name)
J_CG = importlib.import_module("dycoreplanet_tpu.solvers.cg")
SMALL = (8, 16, 32)
SOLVE_TOL = 1e-10
OP_TOL = 1e-12
NEU = BCSpec(BC.NEUMANN, BC.NEUMANN)
SPECS = {"annulus": [NEU, None],
         "shell": [NEU, BCSpec(BC.POLE, BC.POLE), None]}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol, what):
    want, got = np.asarray(want), _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _mean_free(x):
    x = _np(x)
    return x - x.mean()


def _geos(kind):
    if kind == "annulus":
        return (t_factory.make_annulus(16, 48, 1.0, 3.0),
                j_factory.make_annulus(16, 48, 1.0, 3.0))
    if kind == "annulus thin":
        # aqua_planet.prm's aspect: r in [637.1, 647.1]
        return (t_factory.make_annulus(16, 192, 637.1, 647.1),
                j_factory.make_annulus(16, 192, 637.1, 647.1))
    if kind == "shell":
        return (t_factory.make_shell(*SMALL, 1.0, 3.0),
                j_factory.make_shell(*SMALL, 1.0, 3.0))
    if kind == "shell stretched":
        return (stretched_shell(SMALL),
                stretched_shell(SMALL, factory=j_factory,
                                geometry=j_geometry))
    raise KeyError(kind)


def _specs(geo):
    return SPECS[geo.kind]


DIRECT = {"annulus": ("annulus", "AnnulusPoissonDirect"),
          "annulus thin": ("annulus thin", "AnnulusPoissonDirect"),
          "shell": ("shell", "ShellPoissonDirect")}


@pytest.mark.parametrize("case", list(DIRECT))
def test_direct_solves_exact_and_match_jax(case):
    """x_true from a seed, b = -weak_laplacian(x_true): the port's solve
    recovers x_true mean-free (1e-10 of its scale; 1e-8 at the thin
    annulus's aspect, as the JAX test holds it) and agrees with the JAX
    solve of the same b within 1e-10."""
    kind, name = DIRECT[case]
    tgeo, jgeo = _geos(kind)
    rng = np.random.default_rng(2)
    x_true = rng.standard_normal(tgeo.cell_shape)
    x_true -= x_true.mean()
    b = _np(-st.weak_laplacian(tgeo, torch.as_tensor(x_true), _specs(tgeo)))
    sol = getattr(t_spec, name)(tgeo, dtype=np.float64)
    x, its = sol.solve(torch.as_tensor(b))
    assert its == 0 and x.dtype == torch.float64
    xj, itj = getattr(j_spec, name)(jgeo, dtype=jnp.float64).solve(
        jnp.asarray(b))
    assert int(itj) == 0
    _close(_mean_free(x), _mean_free(xj), SOLVE_TOL, f"{case} vs JAX")
    _close(_mean_free(x), x_true, 1e-8 if "thin" in case else SOLVE_TOL,
           f"{case} exact inverse")


def test_shell_spectral_operator_matches_jax():
    """The spectral operator A_k on seeded (nr, nlat, 2nm) values, and
    its constants, against the JAX solver's; A_k mode by mode is the
    transform of -weak_laplacian up to the k = 0 deflation."""
    for kind in ("shell", "shell stretched"):
        tgeo, jgeo = _geos(kind)
        ts = t_spec.ShellPoissonSpectral(tgeo, dtype=np.float64)
        js = j_spec.ShellPoissonSpectral(jgeo, dtype=jnp.float64)
        for name in ("_a_lo", "_a_hi", "_b_lo", "_b_hi", "_diag"):
            np.testing.assert_array_equal(getattr(ts, name),
                                          np.asarray(getattr(js, name)))
        assert ts._defl_scale == js._defl_scale
        xs = np.random.default_rng(5).standard_normal(ts._diag.shape)
        _close(ts._apply(torch.as_tensor(xs)), js._apply(jnp.asarray(xs)),
               OP_TOL, f"{kind} _apply")
        # mode by mode the transform of -weak_laplacian (the JAX test)
        x = np.random.default_rng(6).standard_normal(tgeo.cell_shape)
        xh = np.fft.rfft(x, axis=2)
        ax = _np(ts._apply(torch.as_tensor(np.concatenate(
            [xh.real, xh.imag], axis=2))))
        nm = ts.nm
        back = np.fft.irfft(ax[:, :, :nm] + 1j * ax[:, :, nm:],
                            n=tgeo.cell_shape[2], axis=2)
        lhs = _np(-st.weak_laplacian(tgeo, torch.as_tensor(x),
                                     _specs(tgeo)))
        corr = ts._defl_scale * x.sum() / tgeo.cell_shape[2]
        np.testing.assert_allclose(back - lhs - corr, 0.0, atol=1e-9)


def _reversed_dot(a, b):
    """The JAX CG's dot product with its terms summed in reverse order."""
    acc = jnp.promote_types(a.dtype, jnp.float32)
    return jnp.sum(jnp.flip((a.astype(acc) * b.astype(acc)).reshape(-1)))


def _x_true(geo, seed):
    """A seeded mean-free x_true and b = -weak_laplacian(x_true)."""
    x_true = np.random.default_rng(seed).standard_normal(geo.cell_shape)
    x_true -= x_true.mean()
    b = _np(-st.weak_laplacian(geo, torch.as_tensor(x_true), _specs(geo)))
    return x_true, b


def _check_cg_against_jax(ts, js, b, x_true, monkeypatch, what):
    """The port's solver ``ts`` and the JAX solver ``js`` on b: the JAX
    CG's count is the same with its dot products summed in either order
    (the right-hand sides are chosen so; where it is not, the count is
    decided by round-off, not by the method: ROADMAP Queue 3), and the
    port's count equals it. At rtol <= 1e-11 the port's solution
    (mean-free) is within SOLVE_TOL of the JAX one and both within 1e-7
    of x_true (the JAX test's bound). At a looser rtol two CG runs of
    equal count still differ where the last iterations amplify
    round-off (up to ~1e-6 of the scale at rtol 1e-7), so each
    package's solution is held to x_true within 1e4 x rtol, the JAX
    test's ratio of bound to rtol."""
    x, its = ts.solve(torch.as_tensor(b))
    assert 0 < its < ts.maxiter, (what, its)
    counts, xj = set(), None
    for dot in (None, _reversed_dot):
        with monkeypatch.context() as mp:
            if dot is not None:
                mp.setattr(J_CG, "_dot", dot)
            xo, ito = js.solve(jnp.asarray(b))
        counts.add(int(ito))
        xj = np.asarray(xo) if xj is None else xj
    assert len(counts) == 1, (what, "JAX counts by order", counts)
    assert its == counts.pop(), (what, its)
    if ts.rtol <= 1e-11:
        _close(_mean_free(x), _mean_free(xj), SOLVE_TOL, what)
        tol = 1e-7
    else:
        tol = 1e4 * ts.rtol
    for name, sol in (("port", x), ("JAX", xj)):
        np.testing.assert_allclose(_mean_free(sol), x_true, rtol=0,
                                   atol=tol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("rtol", [1e-7, 1e-11])
@pytest.mark.parametrize("kind", ["shell", "shell stretched"])
def test_shell_spectral_cg_matches_jax(kind, rtol, monkeypatch):
    """The spectral CG at the factory's rtol 1e-7 (cap 120) and at 1e-11
    (cap 300) on b = -weak_laplacian(x_true): the port's CG iteration
    count equals the JAX count, and the solutions agree as
    _check_cg_against_jax says."""
    tgeo, jgeo = _geos(kind)
    x_true, b = _x_true(tgeo, 7)
    cap = 120 if rtol == 1e-7 else 300
    _check_cg_against_jax(
        t_spec.ShellPoissonSpectral(tgeo, dtype=np.float64, rtol=rtol,
                                    maxiter=cap),
        j_spec.ShellPoissonSpectral(jgeo, dtype=jnp.float64, rtol=rtol,
                                    maxiter=cap),
        b, x_true, monkeypatch, f"{kind} rtol {rtol}")


def _blocked_dot(block):
    """The port CG's dot product summed in columns of ``block`` terms
    first."""
    return lambda a, b: torch.sum(torch.sum((a * b).reshape(-1, block), 0))


def test_card_check_count_is_order_free(monkeypatch):
    """The right-hand side of chip_smoke.py's f64 card-against-CPU check
    of ShellPoissonSpectral (the CPU generator's seed 19 on the stretched
    8 x 16 x 32 shell, rtol 1e-11): the port's CG count does not move
    with the order of its dot products' sums, so that equal counts on
    the card and the CPU test the card's arithmetic."""
    geo = _geos("shell stretched")[0]
    gen = torch.Generator().manual_seed(19)
    b = torch.randn(geo.cell_shape, generator=gen, dtype=torch.float64)
    b = b - b.mean()
    t_cg = importlib.import_module("dycoreplanet_tpu_torch.solvers.cg")
    counts = set()
    for block in (None, 1, 2, 4, 16, 17, 34, 68, 136, 272):
        with monkeypatch.context() as mp:
            if block is not None:
                mp.setattr(t_cg, "_dot", _blocked_dot(block))
            counts.add(t_spec.ShellPoissonSpectral(
                geo, dtype=np.float64, rtol=1e-11, maxiter=300).solve(b)[1])
    assert len(counts) == 1, counts


def test_shell_direct_against_spectral_cg():
    """The JAX package's test: the direct solve and the spectral CG at
    rtol 1e-12 agree within 1e-10 (mean-free), and the direct solve's
    residual is round-off (1e-12)."""
    tgeo, _ = _geos("shell")
    rng = np.random.default_rng(0)
    b = rng.standard_normal(tgeo.cell_shape)
    b -= b.mean()
    bt = torch.as_tensor(b)
    xd, _ = t_spec.ShellPoissonDirect(tgeo, dtype=np.float64).solve(bt)
    xc, its = t_spec.ShellPoissonSpectral(
        tgeo, dtype=np.float64, rtol=1e-12, maxiter=2000).solve(bt)
    assert its > 0
    np.testing.assert_allclose(_mean_free(xd), _mean_free(xc), rtol=0,
                               atol=1e-10)
    r = b - _np(-st.weak_laplacian(tgeo, xd, _specs(tgeo)))
    assert np.abs(r - r.mean()).max() < 1e-12


def test_factory_builds_spectral_cg_on_stretched_shell(monkeypatch):
    """make_poisson_solver on the stretched shell: ShellPoissonSpectral in
    both packages with their defaults (rtol 1e-7, cap 120), and with the
    ``rtol`` / ``maxiter`` the JAX factory passes on; iterations and
    solutions as _check_cg_against_jax says. On the uniform shell it
    stays the fast diagonalization."""
    tgeo, jgeo = _geos("shell stretched")
    x_true, b = _x_true(tgeo, 3)
    for kw in ({}, {"rtol": 1e-11, "maxiter": 200}):
        ts = t_spec.make_poisson_solver(tgeo, dtype=np.float64, **kw)
        js = j_spec.make_poisson_solver(jgeo, dtype=jnp.float64, **kw)
        assert type(ts).__name__ == type(js).__name__ == \
            "ShellPoissonSpectral"
        assert (ts.rtol, ts.maxiter) == (js.rtol, js.maxiter)
        _check_cg_against_jax(ts, js, b, x_true, monkeypatch,
                              f"factory {kw}")
    assert isinstance(t_spec.make_poisson_solver(_geos("shell")[0]),
                      t_spec.ShellPoissonFastDiag)


def _shell_model(geo, dtype="float64"):
    p = Parameters.from_text("")
    p.numerics.dtype = dtype
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = geo.cell_shape
    return BoussinesqModel(p, geometry=geo, device="cpu")


def test_stretched_shell_model_runs_no_graph(monkeypatch):
    """The model on the stretched shell takes ShellPoissonSpectral on the
    model's K4 wrapper, and its chunks run no CUDA graph: the spectral
    CG reads its stopping test back every iteration (``iterative``), so
    _graphable is False on the card, where the same model on the uniform
    shell is graphable (the device taken as the card's for the
    question); prepare_sharded accepts it (its sharded spectral CG).
    Three steps through run and as one multi_step chunk from the same
    state: bitwise equal, no escalation,
    the CG stopped at `poisson tol` (1e-8) and `max cg iters` (500) as
    the JAX model passes them, max|div u| <= 1e-6."""
    m = _shell_model(_geos("shell stretched")[0])
    assert isinstance(m.poisson_spectral, t_spec.ShellPoissonSpectral)
    assert m.poisson_spectral.iterative
    assert (m.poisson_spectral.rtol, m.poisson_spectral.maxiter) == (
        m.params.numerics.poisson_tol, m.params.numerics.max_cg_iters)
    assert m.poisson_spectral.tridiag is m.kernels()["tridiag"]
    uniform = _shell_model(_geos("shell")[0])
    for model, graphable in ((m, False), (uniform, True)):
        monkeypatch.setattr(model, "device", torch.device("cuda"))
        assert model._graphable(False, False) is graphable
        monkeypatch.setattr(model, "device", torch.device("cpu"))
    mesh_m = _shell_model(_geos("shell stretched")[0])
    mesh_m.prepare_sharded(Mesh(np.array([["cpu"] * 2] * 2, dtype=object),
                                ("lat", "lon")))
    assert mesh_m.sharded_kernels()["poisson"] == \
        "ShardedShellPoissonSpectral"
    s0 = m.initial_state()
    s_run, hist = m.run(max_steps=3, state=s0)
    s_chunk, rows, _ = m.multi_step(s0, m.params.time_step, 3)
    assert m.escalations == 0 and m.chunk_graphs is None
    for a, b in zip((s_run.u, s_run.p, s_run.T) + tuple(s_run.u_faces),
                    (s_chunk.u, s_chunk.p, s_chunk.T)
                    + tuple(s_chunk.u_faces)):
        assert torch.equal(a, b)
    assert [h["poisson_iters"] for h in hist] == rows[:, 5].int().tolist()
    assert all(h["poisson_iters"] > 0 for h in hist)
    assert max(h["div_norm"] for h in hist) <= 1e-6


LAYOUTS = {"AnnulusPoissonDirect": ("annulus", 2, 1),
           "ShellPoissonDirect": ("shell", 2, 2),
           "ShellPoissonSpectral": ("shell stretched", 1, 2)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_k4_layouts_need_no_copy(name):
    """Each solver's K4 operands as it passes them: no copy; the pair
    axis (size 2, lower, diag and upper broadcast along it) where the
    real and imaginary parts share their coefficients; lower and upper
    one value a row where the radial conductances separate; the number
    of column axes. On the CPU the solve takes the plain version: no
    launch, no copy."""
    kind, pair, n_cols = LAYOUTS[name]
    tgeo, _ = _geos(kind)
    sol = getattr(t_spec, name)(tgeo, dtype=np.float64)
    b = torch.as_tensor(np.random.default_rng(9).standard_normal(
        tgeo.cell_shape))
    if name == "ShellPoissonSpectral":
        nr, nlat, nlon = tgeo.cell_shape
        ops = sol.line_operands(torch.zeros(nr, nlat, 2 * sol.nm,
                                            dtype=torch.float64))
        assert ops[0].shape == ops[2].shape == (nr, nlat, 1)
        assert ops[1].shape == (nr, nlat, 2 * sol.nm)
    else:
        ops = sol.systems(b)
        assert ops[3].shape[-1 if kind == "annulus" else 2] == 2
        assert ops[0].shape == ops[2].shape == (tgeo.cell_shape[0],) + (
            1,) * (ops[3].dim() - 1)
    lay = k4.layout(*ops)
    assert lay.copied == () and lay.pair == pair
    assert lay.row_coefficients == (name != "ShellPoissonSpectral")
    assert sum(s > 1 for s, _ in lay.columns()) == n_cols
    if pair == 2:
        assert lay.axes[lay.pair_axis][0] == 2
        assert all(lay.desc(k)[4] == 0 for k in ("lower", "diag", "upper"))
    assert lay.cols * lay.pair == ops[3][0].numel()
    sol.solve(b)
    assert sol.tridiag.launches == 0 and sol.tridiag.copies == 0
