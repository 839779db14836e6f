"""Matrix-free linear-algebra compositions (PyTorch counterpart of the
JAX package's ``linear_algebra/__init__.py``): the reference's
``include/linear_algebra/`` operator wrappers as higher-order functions
returning closures.

Reference mapping:
  inverse_operator            <- InverseMatrix (inverse_matrix.hpp:93-120)
  approximate_inverse         <- ApproximateInverseMatrix (approximate_inverse.hpp:99-124)
  schur_complement            <- SchurComplement (schur_complement.hpp:143-150)
  approximate_schur_complement<- ApproximateSchurComplement (approximate_schur_complement.hpp:136-142)
  shifted_schur_complement    <- ShiftedSchurComplement (shifted_schur_complement.hpp:155-171)
  nested_schur_complement     <- NestedSchurComplement + zero-mean projection
                                 (nested_schur_complement.hpp:170-183)
  zero_mean                   <- PreconditionerBlockIdentity pressure correction
                                 (preconditioner_block_identity.hpp:31-53)

On a mesh the operands are ``parallel.mesh.Sharded`` fields and
``total`` the mesh's fixed-order sum of the shards' partials
(``ShardedStep.total``): the inner solves take it (solvers/cg.py,
solvers/gmres.py), and ``zero_mean`` sums with it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dycoreplanet_tpu_torch.solvers.cg import cg, mesh_dot
from dycoreplanet_tpu_torch.solvers.gmres import gmres

Op = Callable[[torch.Tensor], torch.Tensor]


def inverse_operator(op: Op, *, preconditioner: Optional[Op] = None,
                     rtol: float = 1e-6, maxiter: int = 500,
                     solver: str = "cg", total: Optional[Callable] = None
                     ) -> Op:
    """A^{-1} action by a fully converged inner Krylov solve (CG, or
    GMRES for ``solver="gmres"``)."""
    if solver == "cg":
        def apply(src):
            return cg(op, src, rtol=rtol, maxiter=maxiter,
                      preconditioner=preconditioner,
                      dot=mesh_dot(total)).x
    else:
        def apply(src):
            return gmres(op, src, rtol=rtol, maxiter=maxiter,
                         preconditioner=preconditioner, total=total).x
    return apply


def approximate_inverse(op: Op, *, n_iter: int, rtol: float = 0.0,
                        preconditioner: Optional[Op] = None,
                        solver: str = "cg",
                        restart: Optional[int] = None,
                        total: Optional[Callable] = None) -> Op:
    """A^{-1} action truncated at ``n_iter`` Krylov iterations (or at
    ``rtol``; 0: none); non-convergence is accepted, as the reference
    swallows it."""
    if solver == "cg":
        def apply(src):
            return cg(op, src, rtol=rtol, maxiter=n_iter,
                      preconditioner=preconditioner,
                      dot=mesh_dot(total)).x
    else:
        r = restart if restart is not None else n_iter

        def apply(src):
            return gmres(op, src, rtol=rtol, maxiter=n_iter, restart=r,
                         preconditioner=preconditioner, total=total).x
    return apply


def schur_complement(B: Op, A_inv: Op, BT: Op) -> Op:
    """S = B A^{-1} B^T as three chained applications."""
    def apply(x):
        return B(A_inv(BT(x)))
    return apply


def approximate_schur_complement(B: Op, M_apply: Op, BT: Op) -> Op:
    """S~ = B M^{-1} B^T with one preconditioner application in place of
    the inner solve."""
    def apply(x):
        return B(M_apply(BT(x)))
    return apply


def shifted_schur_complement(M11: Op, B10: Op, Mw_inv: Op, B01: Op) -> Op:
    """dst = M11 src - B10 Mw^{-1} B01 src."""
    def apply(x):
        return M11(x) - B10(Mw_inv(B01(x)))
    return apply


def zero_mean(weights: Optional[torch.Tensor] = None,
              total: Optional[Callable] = None) -> Op:
    """The (volume-weighted) zero-mean projection: the pressure
    nullspace correction after Schur applications; on a mesh the sums
    are ``total``'s."""
    if total is not None:
        if weights is None:
            def apply(x):
                n = x.numel()
                return x - total(x.map(torch.sum)) / n
        else:
            w_total = total(weights.map(torch.sum))

            def apply(x):
                return x - total((x * weights).map(torch.sum)) / w_total
        return apply
    if weights is None:
        def apply(x):
            return x - torch.mean(x)
    else:
        w_sum = weights.sum()

        def apply(x):
            return x - (x * weights).sum() / w_sum
    return apply


def nested_schur_complement(B: Op, S_inv: Op, BT: Op,
                            weights: Optional[torch.Tensor] = None,
                            total: Optional[Callable] = None) -> Op:
    """The pressure Schur complement B S^{-1} B^T with the zero-mean
    projection after each application."""
    project = zero_mean(weights, total)

    def apply(x):
        return project(B(S_inv(BT(x))))
    return apply
