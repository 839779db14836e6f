"""K4 in ``CuboidPoissonDirect``'s layout on a CUDA card: the z systems of
every (y, x) mode of an rfft2, the real and imaginary parts as K4's pair
axis (rhs ``torch.view_as_real`` of the transform, diag broadcast along
it, lower and upper one value a row), against K4's plain version, from
numpy-seeded right-hand sides. Imports neither JAX nor the JAX package,
so that it runs on a machine with a card and no JAX; it skips without a
card."""

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.grid.factory import make_cuboid
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.solvers.spectral import (
    CuboidPoissonDirect, CuboidPoissonFastDiag)


@pytest.mark.cuda
def test_cuda_k4_on_the_cuboid_poisson_layout():
    """On a card, at 16 x 24 x 32, f32 and f64: K4 on the solver's
    operands as passed against its plain version (atol = 1e-5 x scale in
    f32, 1e-12 in f64), one launch a solve and no operand copied; the
    whole solve an inverse of -weak_laplacian on a mean-free rhs and,
    mean-free, the fast diagonalization's solution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    geo = make_cuboid(16, 24, 32)
    specs = [BCSpec(BC.NEUMANN, BC.NEUMANN), None, None]
    for dtype in (np.float32, np.float64):
        solver = CuboidPoissonDirect(geo, dtype=dtype, device=dev)
        b = np.random.default_rng(12).standard_normal(geo.cell_shape)
        b = torch.as_tensor((b - b.mean()).astype(dtype), device=dev)
        sys4 = solver.systems(b)
        want = solver.tridiag.plain(*sys4)
        got = solver.tridiag(*sys4)
        sc = float(want.abs().max())
        tol = (1e-5 if dtype == np.float32 else 1e-12) * sc
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=tol)
        assert (solver.tridiag.launches, solver.tridiag.copies) == (1, 0)
        x = solver.solve(b)[0]
        assert (solver.tridiag.launches, solver.tridiag.copies) == (2, 0)
        rtol = 1e-5 if dtype == np.float32 else 1e-11
        res = -st.weak_laplacian(geo, x, specs) - b
        assert float(res.norm() / b.norm()) <= rtol
        xf = CuboidPoissonFastDiag(geo, dtype=dtype, device=dev).solve(b)[0]
        d = (x - x.mean()) - (xf - xf.mean())
        assert float(d.abs().max() / xf.abs().max()) <= rtol
