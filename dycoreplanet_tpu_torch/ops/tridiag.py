"""K4: the batched tridiagonal solve as a hand-written CUDA kernel, with
its plain version (``solvers.tridiag.thomas_solve``).

Replaces the Pallas kernel ``tridiag_pallas``
(dycoreplanet_tpu/ops/pallas_kernels.py:59) and has the contract of the
JAX package's ``tridiag_solve`` (pallas_kernels.py:131): systems along
axis 0, every trailing axis flattened (C order) into the batch,
coefficients broadcastable to ``rhs``. The direct Helmholtz solvers
(solvers/helmholtz.py) call it. Kernel source: csrc/tridiag.cu.

Bound: device-memory traffic — each operand read once as the caller
passes it (a broadcast coefficient counts only the values it holds) and
x written once: ``values_moved``. The wrapper materializes broadcast
coefficients to (n, m), as ``tridiag_pallas`` does, so the kernel reads
more than the bound counts.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.solvers.tridiag import thomas_solve

# floating-point operations per value of rhs: 2 multiplies, 2
# subtractions and 2 divisions forward, a multiply and a subtraction back
OPS_PER_VALUE = 8


def values_moved(lower, diag, upper, rhs) -> int:
    """Values the solve must move: every operand read once as passed,
    counting the values it holds (an axis of stride 0 counts once), and
    x, of rhs's size, written once."""
    def held(a):
        a = torch.as_tensor(a)
        return math.prod(s for s, st in zip(a.shape, a.stride()) if st != 0)
    return sum(held(a) for a in (lower, diag, upper, rhs)) + rhs.numel()


class TridiagSolve:
    """Callable ``(lower, diag, upper, rhs) -> x``, one instance per model
    (its ``launches`` counts the CUDA launches). CPU tensors take the
    plain version; a CUDA ``rhs`` launches the kernel or raises."""

    def __init__(self):
        self._fn = {}
        self.launches = 0

    @staticmethod
    def plain(lower, diag, upper, rhs):
        return thomas_solve(lower, diag, upper, rhs)

    def __call__(self, lower, diag, upper, rhs):
        if rhs.device.type == "cpu":
            return self.plain(lower, diag, upper, rhs)
        dev, dtype = kl.require_cuda("tridiag", {"rhs": (rhs, rhs.shape)})
        n = rhs.shape[0]
        batch = tuple(rhs.shape[1:])
        m = math.prod(batch)
        if n < 1 or m < 1:
            raise ValueError(f"tridiag: empty system {tuple(rhs.shape)}")
        flat = lambda a: torch.as_tensor(a).to(dtype).expand(
            (n,) + batch).reshape(n, m).contiguous()
        # upper is always the wrapper's own copy: for a large n the kernel
        # overwrites it with c' (csrc/tridiag.cu thomas_general)
        up = torch.as_tensor(upper)
        upper_own = torch.empty((n,) + batch, dtype=dtype, device=up.device)
        upper_own.copy_(up.expand((n,) + batch))
        ops = {"lower": flat(lower), "diag": flat(diag),
               "upper": upper_own.view(n, m), "rhs": rhs.view(n, m)}
        kl.require_cuda("tridiag", {k: (a, (n, m)) for k, a in ops.items()})
        sfx = kl.suffix(dtype)
        fn = self._fn.get(sfx)
        if fn is None:
            P = ctypes.c_void_p
            fn = kl.bind("tridiag.cu", f"dp_tridiag_{sfx}",
                         [ctypes.c_int, ctypes.c_int64] + [P] * 6)
            self._fn[sfx] = fn
        x = torch.empty((n, m), dtype=dtype, device=dev)
        p = kl.ptr
        kl.check(fn(n, m, p(ops["lower"]), p(ops["diag"]), p(ops["upper"]),
                    p(ops["rhs"]), p(x), kl.stream_of(rhs)),
                 "tridiag kernel")
        self.launches += 1
        return x.view((n,) + batch)
