"""Batched tridiagonal solves (Thomas algorithm), the PyTorch counterpart
of the JAX package's ``solvers/tridiag.py``.

Solves many independent tridiagonal systems along the LEADING axis,
batched over all trailing axes. This is the plain version of the K4
kernel (ops/tridiag.py, csrc/tridiag.cu): the two recurrences are a
Python loop over n, each step one vector operation over the batch.
"""

from __future__ import annotations

import torch


def thomas_solve(lower: torch.Tensor, diag: torch.Tensor,
                 upper: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(lower, diag, upper) x = rhs along axis 0.

    ``lower[0]`` and ``upper[n-1]`` are unused. No pivoting: valid for
    the diagonally dominant / SPD systems of the FV operators here.
    Coefficients broadcast against ``rhs``; the recurrences run in at
    least float32, as in the JAX function."""
    acc = torch.promote_types(torch.promote_types(diag.dtype, rhs.dtype),
                              torch.float32)
    lower, diag, upper, rhs = (a.to(acc) for a in (lower, diag, upper, rhs))
    n = rhs.shape[0]

    # forward sweep: c'_i = u_i / (d_i - l_i c'_{i-1}),
    #                g_i  = (b_i - l_i g_{i-1}) / (d_i - l_i c'_{i-1})
    c_prev = torch.zeros_like(diag[0])
    g_prev = torch.zeros(torch.broadcast_shapes(diag[0].shape, rhs[0].shape),
                         dtype=acc, device=rhs.device)
    cs, gs = [], []
    for i in range(n):
        denom = diag[i] - lower[i] * c_prev
        c_prev = upper[i] / denom
        g_prev = (rhs[i] - lower[i] * g_prev) / denom
        cs.append(c_prev)
        gs.append(g_prev)

    # back substitution: x_i = g_i - c'_i x_{i+1}
    x_next = torch.zeros_like(g_prev)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = gs[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs)
