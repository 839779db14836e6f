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
``record_history`` > 0 records the residual norm after each iteration
(NaN-padded to that length), as the JAX package's does. On a mesh ``b``
is a ``parallel.mesh.Sharded`` field and ``dot`` the mesh's inner
product, as in solvers/cg.py.
"""

from __future__ import annotations

from typing import Callable

import torch

from dycoreplanet_tpu_torch.solvers.cg import CGResult, _dot


def richardson_solve(operator: Callable[[torch.Tensor], torch.Tensor],
                     b: torch.Tensor, x0: torch.Tensor, *,
                     diag: torch.Tensor, iters: int = 2,
                     rtol: float = 1e-8,
                     track_residual: bool = True,
                     record_history: int = 0,
                     dot: Callable = _dot) -> CGResult:
    """``iters`` unrolled Jacobi-Richardson steps on A x = b, ``dot`` the
    inner product."""
    if record_history > 0 and not track_residual:
        raise ValueError("record_history needs track_residual")
    x = x0.to(b.dtype)
    eps = torch.finfo(b.dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    r = b - operator(x)
    hist = []
    for j in range(iters):
        dx = r / diag
        x = x + dx
        if track_residual or j + 1 < iters:
            r = r - operator(dx)
        if record_history > 0:
            hist.append(torch.sqrt(dot(r, r)).to(torch.float32))
    if not track_residual:
        return CGResult(
            x=x, iterations=iters,
            residual_norm=torch.full((), -1.0, dtype=b.dtype,
                                     device=b.device),
            converged=torch.ones((), dtype=torch.bool, device=b.device))
    rnorm = torch.sqrt(dot(r, r))
    stop = rtol_eff * torch.sqrt(dot(b, b))
    history = None
    if record_history > 0:
        pad = max(record_history - len(hist), 0)
        history = torch.cat([
            torch.stack(hist)[:record_history],
            torch.full((pad,), float("nan"), dtype=torch.float32,
                       device=b.device)])
    return CGResult(x=x, iterations=iters, residual_norm=rnorm,
                    converged=rnorm <= stop, history=history)
