"""K4 on the 2D annulus's direct Helmholtz operands on a CUDA card: the
layout ``AnnulusHelmholtzDirect`` passes (lower and upper one value a
row, diag (nr, C, 2nm), rhs a strided view of the (C, nr, 2nm)
transform) against K4's plain version, from numpy-seeded right-hand
sides. Imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX; it skips without a card."""

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.grid.factory import make_annulus
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.solvers.helmholtz import AnnulusHelmholtzDirect

AS, NEU = BC.ANTISYM, BC.NEUMANN


@pytest.mark.cuda
def test_cuda_k4_on_the_annulus_layout():
    """On a card: K4 on AnnulusHelmholtzDirect's operands as passed
    (momentum C = 2, temperature C = 1), f32 and f64, against its plain
    version (atol = 1e-5 x scale in f32, 1e-12 in f64): one launch,
    no operand copied, and the whole direct solve inverting the operator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for shape in ((8, 48), (64, 768)):
        geo = make_annulus(*shape, 10.0, 30.0)
        vol = torch.as_tensor(np.broadcast_to(geo.vol, shape).copy(),
                              device="cuda")
        for dtype in (np.float32, np.float64):
            for specs in ([BCSpec(AS, AS), BCSpec(AS, NEU)],
                          [BCSpec(AS, NEU)]):
                solver = AnnulusHelmholtzDirect(geo, specs, dtype=dtype,
                                                device=torch.device("cuda"))
                b = torch.as_tensor(np.random.default_rng(11).standard_normal(
                    (len(specs),) + shape).astype(dtype), device="cuda")
                sys4 = solver.systems(b, 0.3)
                want = solver.tridiag.plain(*sys4)
                got = solver.tridiag(*sys4)
                sc = float(want.abs().max())
                tol = (1e-5 if dtype == np.float32 else 1e-12) * sc
                np.testing.assert_allclose(got.cpu().numpy(),
                                           want.cpu().numpy(), rtol=0,
                                           atol=tol)
                assert (solver.tridiag.launches,
                        solver.tridiag.copies) == (1, 0)
                x = solver.solve(b, 0.3)
                res = vol[None].to(x.dtype) * x - 0.3 * torch.stack([
                    st.weak_laplacian(geo, x[k], [specs[k], None])
                    for k in range(len(specs))])
                rres = float((res - b).norm() / b.norm())
                assert rres <= (1e-5 if dtype == np.float32 else 1e-11)
