"""Fixed-iteration Jacobi-Richardson solve for mass-dominated systems
(PyTorch counterpart of the JAX package's ``solvers/fixed.py``).

    x_{j+1} = x_j + D^{-1} (b - A x_j)

with the residual tracked exactly (r_{j+1} = r_j - A D^{-1} r_j, no
extra apply) and the reference's stopping test ||r|| <= rtol*||b||
(boussinesq_model.tpp:1426-1440) evaluated into ``converged``. There is
no in-loop fallback: the model retries the whole step with full CG when
``converged`` is False (the reference's NoConvergence retry,
boussinesq_model.tpp:1203-1232). This is the plain version of the
Richardson stage of kernel K1 (ops/richardson.py); ``track_residual=False``
that of K1's residual-free variant, which skips the last residual update
and reports the residual norm as the -1 sentinel ("not checked").
"""

from __future__ import annotations

from typing import Callable

import torch

from dycoreplanet_tpu_torch.solvers.cg import CGResult, _dot


def richardson_solve(operator: Callable[[torch.Tensor], torch.Tensor],
                     b: torch.Tensor, x0: torch.Tensor, *,
                     diag: torch.Tensor, iters: int = 2,
                     rtol: float = 1e-8,
                     track_residual: bool = True) -> CGResult:
    """``iters`` unrolled Jacobi-Richardson steps on A x = b."""
    x = x0.to(b.dtype)
    eps = torch.finfo(b.dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    r = b - operator(x)
    for j in range(iters):
        dx = r / diag
        x = x + dx
        if track_residual or j + 1 < iters:
            r = r - operator(dx)
    if not track_residual:
        return CGResult(
            x=x, iterations=iters,
            residual_norm=torch.full((), -1.0, dtype=b.dtype,
                                     device=b.device),
            converged=torch.ones((), dtype=torch.bool, device=b.device))
    rnorm = torch.sqrt(_dot(r, r))
    stop = rtol_eff * torch.sqrt(_dot(b, b))
    return CGResult(x=x, iterations=iters, residual_norm=rnorm,
                    converged=rnorm <= stop)
