"""Matrix-free preconditioned conjugate gradients (PyTorch).

Counterpart of the JAX package's ``solvers/cg.py``, with its safeguards:
  * the relative tolerance is clamped to 16*eps(dtype);
  * the best iterate (smallest residual norm) is tracked and returned,
    and the loop aborts once the residual grows ``divergence_factor``
    times above the best seen (finite-precision CG past its attainable
    accuracy diverges rather than stagnates).
Stop when ||r|| <= rtol * ||b|| (reference SolverControl semantics,
inverse_matrix.hpp:93-120). The loop runs on the host: each iteration
reads its stopping test back from the device. CG only runs on the
escalated steps of the fast path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # scalar tensor, best ||r|| reached
    converged: torch.Tensor      # scalar bool tensor


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def cg(operator: Callable[[torch.Tensor], torch.Tensor],
       b: torch.Tensor,
       x0: Optional[torch.Tensor] = None,
       *,
       rtol: float = 1e-8,
       atol: float = 0.0,
       maxiter: int = 500,
       preconditioner: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
       divergence_factor: float = 32.0) -> CGResult:
    """Solve A x = b for an SPD matrix-free ``operator`` with an SPD
    ``preconditioner``. Returns the best iterate seen."""
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    M = preconditioner if preconditioner is not None else (lambda r: r)
    eps = torch.finfo(b.dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    b_norm = torch.sqrt(_dot(b, b))
    stop = torch.clamp(rtol_eff * b_norm, min=atol)

    r = b - operator(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    rnorm = torch.sqrt(_dot(r, r))
    x_best, rbest = x, rnorm
    k = 0
    while (k < maxiter and bool(rnorm > stop)
           and bool(rnorm < divergence_factor * rbest + stop)):
        Ap = operator(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / pAp, torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        rnorm = torch.sqrt(_dot(r, r))
        k += 1
        if bool(rnorm < rbest):
            x_best, rbest = x, rnorm
    return CGResult(x=x_best, iterations=k, residual_norm=rbest,
                    converged=rbest <= stop)
