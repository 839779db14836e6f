"""Matrix-free restarted GMRES / FGMRES (PyTorch counterpart of the JAX
package's ``solvers/gmres.py``).

The reference's non-SPD Krylov paths: SolverGMRES inside the Schur
pressure solve and the approximate inverses (boussinesq_model.tpp:
1332-1374, shifted_schur_complement.hpp:284), and SolverFGMRES for the
outer block-preconditioned momentum solves (boussinesq_model.tpp:
1166-1232, boussineq_model_FEEC.tpp:1268-1477).

As in the JAX package:
  * right preconditioning, so that the residual norm is the true one;
    ``flexible=True`` stores z_j = M(v_j) (true FGMRES, M may vary
    between applications) and updates x += Z y;
  * the Arnoldi orthogonalization is classical Gram-Schmidt done twice
    (CGS2), each pass one matrix-vector product pair;
  * the small dense algebra (the rotated Hessenberg H, the Givens cs,
    sn and the residual estimates g) is held in promote(dtype, float32)
    and stays on the device; the back substitution pins the y_j of a
    zero diagonal entry (happy breakdown) to 0;
  * a cycle ends early once the rotated estimate |g[j]| meets the
    tolerance, the best iterate over the cycles is returned, and
    ``record_history`` records the true residual after each cycle.

The loops run on the host: each Arnoldi step reads its stopping test
back once, and each cycle the outer test, as ``solvers/cg.py`` does.
Where the JAX package masks the full (restart + 1, n) buffer V, the CGS2
passes and the update here read only the j + 1 rows written so far:
the same products, less memory traffic.

The same loop runs on a mesh: ``b`` a ``parallel.mesh.Sharded`` field and
``total`` the mesh's fixed-order sum of the shards' partials
(parallel/sharded_step.py ``ShardedStep.total``). Each shard holds
its own columns of V and Z; every product of the Arnoldi step, each
norm and inner product, is a per-shard partial ((j + 1)-vectors for the
CGS2 passes) summed by ``total`` in a fixed order on the first device,
in float32 at the least. The small dense algebra stays there; the CGS2
updates, the best iterate and the cycle's update run on the shards.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from dycoreplanet_tpu_torch.parallel.mesh import Sharded
from dycoreplanet_tpu_torch.solvers.cg import (
    CGResult, _dot, _zeros_like, mesh_dot)


def _parts(v) -> List[torch.Tensor]:
    """A vector's tensors: itself, or a Sharded's shards (this
    process's) in shard order."""
    return v.parts() if isinstance(v, Sharded) else [v]


def _whole(parts: List[torch.Tensor], like):
    """The vector of ``parts`` shaped as ``like`` (a tensor or a
    Sharded)."""
    if not isinstance(like, Sharded):
        return parts[0]
    return like.with_parts(parts)


def _on(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The loop's small tensor ``s`` on ``t``'s device (itself there)."""
    return s.to(t.device)


def gmres(operator: Callable[[torch.Tensor], torch.Tensor],
          b: torch.Tensor,
          x0: Optional[torch.Tensor] = None,
          *,
          rtol: float = 1e-8,
          atol: float = 0.0,
          restart: int = 30,
          maxiter: int = 300,
          preconditioner: Optional[Callable[[torch.Tensor],
                                            torch.Tensor]] = None,
          flexible: bool = False,
          record_history: int = 0,
          total: Optional[Callable] = None) -> CGResult:
    """Solve A x = b for a general matrix-free ``operator``:
    right-preconditioned GMRES(restart), stopping when ||b - A x|| <=
    max(rtol ||b||, atol) (rtol clamped to 16 eps) or after ``maxiter``
    Krylov steps, rounded up to whole cycles. ``iterations`` counts the
    Arnoldi steps taken. ``total``: the mesh's sum of the shards'
    partials, for a Sharded ``b``."""
    sharded = isinstance(b, Sharded)
    if sharded and total is None:
        raise ValueError("gmres on a Sharded b needs the mesh's total")
    x0 = _zeros_like(b) if x0 is None else x0.to(b.dtype)
    M = preconditioner if preconditioner is not None else (lambda r: r)
    m = int(restart)
    dtype = b.dtype
    shapes = [t.shape for t in _parts(b)]
    dev = _parts(b)[0].device
    acc = torch.promote_types(dtype, torch.float32)   # small dense algebra
    eps = torch.finfo(dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    dot = mesh_dot(total if sharded else None)

    def reduce(partials):
        """The sum of the parts' partials, on the first device."""
        return total(_whole(partials, b)) if sharded else partials[0]

    def rows(k):
        return [torch.zeros((k, t.numel()), dtype=dtype, device=t.device)
                for t in _parts(b)]

    def row(B, i):
        return _whole([Bp[i].reshape(s) for Bp, s in zip(B, shapes)], b)

    stop = torch.clamp(rtol_eff * torch.sqrt(dot(b, b)), min=atol)

    def cycle(x):
        """One GMRES(m) cycle from x: (x_new, ||b - A x_new||, steps)."""
        r = b - operator(x)
        beta = torch.sqrt(dot(r, r))
        inv_beta = torch.where(beta > 0, 1.0 / beta, torch.zeros_like(beta))
        V = rows(m + 1)
        for Vp, rp in zip(V, _parts(r)):
            Vp[0] = rp.reshape(-1) * _on(rp, inv_beta)
        Z = rows(m) if flexible else None
        H = torch.zeros((m + 1, m), dtype=acc, device=dev)
        # G[i]: the 2x2 Givens rotation [[c, s], [-s, c]] of step i
        G = torch.zeros((m, 2, 2), dtype=acc, device=dev)
        g = torch.zeros((m + 1,), dtype=acc, device=dev)
        g[0] = beta
        j = 0
        # |g[j]|: the rotated residual estimate after j steps
        while j < m and bool(torch.abs(g[j]) > stop):
            z = M(row(V, j))
            if flexible:
                for Zp, zp in zip(Z, _parts(z)):
                    Zp[j] = zp.reshape(-1)
            w = [t.reshape(-1).to(acc) for t in _parts(operator(z))]
            Vj = [Vp[:j + 1].to(acc) for Vp in V]
            h1 = reduce([Vp @ wp for Vp, wp in zip(Vj, w)])
            w = [wp - Vp.T @ _on(wp, h1) for Vp, wp in zip(Vj, w)]
            h2 = reduce([Vp @ wp for Vp, wp in zip(Vj, w)])
            w = [wp - Vp.T @ _on(wp, h2) for Vp, wp in zip(Vj, w)]
            hj1 = torch.sqrt(reduce([torch.sum(wp * wp) for wp in w]))
            inv = torch.where(hj1 > 0, 1.0 / hj1, torch.zeros_like(hj1))
            for Vp, wp in zip(V, w):
                Vp[j + 1] = wp * _on(wp, inv)
            hcol = torch.zeros((m + 1,), dtype=acc, device=dev)
            hcol[:j + 1] = h1 + h2
            hcol[j + 1] = hj1
            for i in range(j):          # the j earlier rotations
                hcol[i:i + 2] = G[i] @ hcol[i:i + 2]
            # the new rotation, annihilating hcol[j + 1]
            a_, b_ = hcol[j], hcol[j + 1]
            rho = torch.sqrt(a_ * a_ + b_ * b_)
            inv_rho = torch.where(rho > 0, 1.0 / rho, torch.zeros_like(rho))
            c = torch.where(rho > 0, a_ * inv_rho, torch.ones_like(rho))
            s = b_ * inv_rho
            G[j] = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
            hcol[j] = rho
            hcol[j + 1] = 0.0
            H[:, j] = hcol
            gj = g[j].clone()
            g[j + 1] = -s * gj
            g[j] = c * gj
            j += 1
        # back substitution R y = g[:m], R = H[:m, :m] upper triangular,
        # a zero diagonal entry (unset column or happy breakdown) pinned
        # to y_j = 0; y_j = 0 for every j >= the steps taken
        R = H[:m, :m]
        alive = (torch.abs(torch.diagonal(R)) > 0).to(acc)
        R = R + torch.diag(1.0 - alive)
        y = torch.linalg.solve_triangular(
            R, (g[:m] * alive)[:, None], upper=True)[:, 0]
        if flexible:
            yd = y[:j].to(dtype)
            x_new = (x + _whole([(Zp[:j].T @ _on(Zp, yd)).reshape(s)
                                 for Zp, s in zip(Z, shapes)], b)).to(dtype)
        else:
            dx = _whole([(Vp[:j].to(acc).T @ _on(Vp, y[:j])).reshape(s)
                         for Vp, s in zip(V, shapes)], b)
            x_new = (x + M(dx)).to(dtype)
        r_new = b - operator(x_new)
        return x_new, torch.sqrt(dot(r_new, r_new)), j

    def where(cond, u, v):
        return _whole([torch.where(_on(up, cond), up, vp)
                       for up, vp in zip(_parts(u), _parts(v))], b)

    r0 = b - operator(x0)
    rnorm = torch.sqrt(dot(r0, r0))
    max_cycles = max(1, -(-maxiter // m))
    cap = int(record_history)
    hist = (torch.full((cap,), float("nan"), dtype=torch.float32, device=dev)
            if cap > 0 else None)
    x, x_best, rbest = x0, x0, rnorm
    k = iters = 0
    while k < max_cycles and bool(rnorm > stop):
        x, rnorm, j_done = cycle(x)
        if hist is not None:
            # the per-cycle residual trail (deallog analogue,
            # reference main.cxx:89-90)
            hist[min(k, cap - 1)] = rnorm.to(torch.float32)
        better = rnorm < rbest
        x_best = where(better, x, x_best)
        rbest = torch.where(better, rnorm, rbest)
        k += 1
        iters += j_done
    return CGResult(x=x_best, iterations=iters, residual_norm=rbest,
                    converged=rbest <= stop, history=hist)
