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
escalated steps of the fast path. ``record_history`` > 0 records the
per-iteration residual norms (the solver trails of ``solver diagnostics
level`` >= 3).

The same loop runs on a mesh: ``b`` a ``parallel.mesh.Sharded`` field
(whose arithmetic is shard by shard) and ``dot`` the mesh's inner
product (every shard's ``_dot``, summed in a fixed order on the first
device, parallel/sharded_step.py). The loop's scalars live on that
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # scalar tensor, best ||r|| reached
    converged: torch.Tensor      # scalar bool tensor
    # per-iteration ||r|| trail, float32, NaN-padded to the cap, when the
    # solve was called with record_history > 0 (reference: the deallog
    # solver histories of `solver diagnostics level` >= 3,
    # main.cxx:89-90); None otherwise
    history: Optional[torch.Tensor] = None


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b), accumulated in float32 at the least (bfloat16 operands
    widened first, as the JAX package's ``_dot``)."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.sum(a.to(acc) * b.to(acc))


def mesh_dot(total: Optional[Callable] = None) -> Callable:
    """The Krylov loops' inner product: ``_dot``, or on a mesh (``total``
    the fixed-order sum of the shards' partials, parallel/sharded_step.py)
    every shard's ``_dot`` summed by ``total``."""
    if total is None:
        return _dot
    return lambda a, b: total(a.map(_dot, b))


def _zeros_like(b):
    return torch.zeros_like(b) if torch.is_tensor(b) else b.zeros_like()


def cg(operator: Callable[[torch.Tensor], torch.Tensor],
       b: torch.Tensor,
       x0: Optional[torch.Tensor] = None,
       *,
       rtol: float = 1e-8,
       atol: float = 0.0,
       maxiter: int = 500,
       preconditioner: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
       divergence_factor: float = 32.0,
       record_history: int = 0,
       dot: Callable = _dot) -> CGResult:
    """Solve A x = b for an SPD matrix-free ``operator`` with an SPD
    ``preconditioner``, ``dot`` the inner product. Returns the best
    iterate seen. With ``record_history`` > 0 the residual norm after
    iteration k goes to ``history[min(k, cap - 1)]``, as in the JAX
    package."""
    x = _zeros_like(b) if x0 is None else x0.to(b.dtype)
    M = preconditioner if preconditioner is not None else (lambda r: r)
    eps = torch.finfo(b.dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    b_norm = torch.sqrt(dot(b, b))
    stop = torch.clamp(rtol_eff * b_norm, min=atol)

    r = b - operator(x)
    z = M(r)
    p = z
    rz = dot(r, z)
    rnorm = torch.sqrt(dot(r, r))
    x_best, rbest = x, rnorm
    cap = int(record_history)
    hist = (torch.full((cap,), float("nan"), dtype=torch.float32,
                       device=b.device) if cap > 0 else None)
    k = 0
    while (k < maxiter and bool(rnorm > stop)
           and bool(rnorm < divergence_factor * rbest + stop)):
        Ap = operator(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / pAp, torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        rnorm = torch.sqrt(dot(r, r))
        if hist is not None:
            hist[min(k, cap - 1)] = rnorm.to(torch.float32)
        k += 1
        if bool(rnorm < rbest):
            x_best, rbest = x, rnorm
    return CGResult(x=x_best, iterations=k, residual_norm=rbest,
                    converged=rbest <= stop, history=hist)
