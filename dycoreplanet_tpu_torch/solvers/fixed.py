"""Fixed-iteration Jacobi-Richardson solve for mass-dominated systems
(PyTorch counterpart of the JAX package's ``solvers/fixed.py``).

    x_{j+1} = x_j + D^{-1} (b - A x_j)

with the residual tracked exactly (r_{j+1} = r_j - A D^{-1} r_j, no
extra apply) and the reference's stopping test ||r|| <= rtol*||b||
(boussinesq_model.tpp:1426-1440) evaluated into ``converged``. There is
no in-loop fallback: the model retries the whole step with full CG when
``converged`` is False (the reference's NoConvergence retry,
boussinesq_model.tpp:1203-1232). This is the plain version of the
Richardson stage of kernel K1 (ops/richardson.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from dycoreplanet_tpu_torch.solvers.cg import CGResult, _dot


def richardson_solve(operator: Callable[[torch.Tensor], torch.Tensor],
                     b: torch.Tensor, x0: torch.Tensor, *,
                     diag: torch.Tensor, iters: int = 2,
                     rtol: float = 1e-8) -> CGResult:
    """``iters`` unrolled Jacobi-Richardson steps on A x = b."""
    x = x0.to(b.dtype)
    eps = torch.finfo(b.dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    r = b - operator(x)
    for _ in range(iters):
        dx = r / diag
        x = x + dx
        r = r - operator(dx)
    rnorm = torch.sqrt(_dot(r, r))
    stop = rtol_eff * torch.sqrt(_dot(b, b))
    return CGResult(x=x, iterations=iters, residual_norm=rnorm,
                    converged=rnorm <= stop)
