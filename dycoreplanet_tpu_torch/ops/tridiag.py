"""K4: the batched tridiagonal solve as a hand-written CUDA kernel, with
its plain version (``solvers.tridiag.thomas_solve``).

Replaces the Pallas kernel ``tridiag_pallas``
(dycoreplanet_tpu/ops/pallas_kernels.py:59) and has the contract of the
JAX package's ``tridiag_solve`` (pallas_kernels.py:131): systems along
axis 0, every trailing axis flattened (C order) into the batch,
coefficients broadcastable to ``rhs``. The direct Helmholtz solvers
(solvers/helmholtz.py), ``CuboidPoissonDirect`` (solvers/spectral.py:
its rhs is ``torch.view_as_real`` of an rfft2, whose trailing axis of 2
is the pair axis) and the multigrid line smoother (solvers/multigrid.py:
contiguous coefficients against the residual's moved-axis view, and on
a periodic axis the Sherman-Morrison pair stacked on axis 1, where the
coefficients are broadcast) call it. Kernel source: csrc/tridiag.cu.

The kernel reads every operand as the caller passes it: ``layout``
describes each one by a row stride and the strides of at most three
batch axes (stride 0 where it is broadcast), adjacent axes merged where
every operand allows. Only an operand that no such description covers
is copied once (``TridiagSolve.copies`` counts them); the direct solvers'
operands never are. Where an axis of size 2 is broadcast in lower, diag
and upper alike (the real/imaginary axis of the direct solves), one
thread solves both systems with one reciprocal a row.

Bound: device-memory traffic — each operand read once as passed (a
broadcast axis counts once) and x written once: ``values_moved``.

float32 and float64 operands give x in their dtype. A bfloat16 rhs (the
multigrid line smoother's residual lines under a bfloat16 model) takes
float32 coefficients and gives x in float32: the kernel widens each rhs
value as it reads it and runs the recurrences in float32, as the plain
version does, which returns float32 too.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.solvers.tridiag import thomas_solve

# floating-point operations per value of rhs: 2 multiplies, 2
# subtractions and 2 divisions forward, a multiply and a subtraction back
OPS_PER_VALUE = 8
# the kernel's operands in the order of its description
NAMES = ("lower", "diag", "upper", "rhs", "x")
MAX_AXES = 3
# threads a block, largest first (block_size)
BLOCKS = (128, 64, 32)


def values_moved(lower, diag, upper, rhs) -> int:
    """Values the solve must move: every operand read once as passed,
    counting the values it holds (an axis of stride 0 counts once), and
    x, of rhs's size, written once."""
    def held(a):
        a = torch.as_tensor(a)
        return math.prod(s for s, st in zip(a.shape, a.stride()) if st != 0)
    return sum(held(a) for a in (lower, diag, upper, rhs)) + rhs.numel()


def _contiguous_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _axes(strides, batch):
    """The batch axes of size > 1 as [(size, stride of each operand)],
    adjacent axes merged where every operand's strides allow."""
    axes = []
    for k, size in enumerate(batch):
        if size == 1:
            continue
        st = tuple(s[k + 1] for s in strides)
        if axes and all(p == q * size for p, q in zip(axes[-1][1], st)):
            axes[-1] = (axes[-1][0] * size, st)
        else:
            axes.append((size, st))
    return axes


class Layout(NamedTuple):
    """How the kernel reads the operands of one solve: operand k's
    element (i, b) lies at ``rows[k] * i + sum(stride_k * index)`` over
    ``axes`` (b in C order), from the start of ``operands[k]``. A thread
    owns a column: the index of every axis but ``pair_axis``, and both
    systems along ``pair_axis`` if there is one."""

    n: int
    m: int
    rows: Tuple[int, ...]
    axes: Tuple[Tuple[int, Tuple[int, ...]], ...]
    pair_axis: Optional[int]
    operands: Dict[str, torch.Tensor]
    copied: Tuple[str, ...]

    @property
    def pair(self) -> int:
        return 1 if self.pair_axis is None else 2

    def columns(self):
        """The three column axes (C order, padded with size-1 axes in
        front) as [(size, stride of each operand)]."""
        cols = [a for k, a in enumerate(self.axes) if k != self.pair_axis]
        return [(1, (0,) * len(NAMES))] * (MAX_AXES - len(cols)) + cols

    @property
    def row_coefficients(self) -> bool:
        """lower and upper vary along rows only (a block stages them
        once)."""
        return all(not any(self.desc(k)[1:]) for k in ("lower", "upper"))

    @property
    def cols(self) -> int:
        return math.prod(s for s, _ in self.columns())

    def desc(self, name: str) -> Tuple[int, ...]:
        """Operand `name` as the kernel takes it: row stride, the three
        column strides, the pair stride."""
        k = NAMES.index(name)
        pair = 0 if self.pair_axis is None else self.axes[self.pair_axis][1][k]
        return ((self.rows[k],) + tuple(st[k] for _, st in self.columns())
                + (pair,))


def layout(lower, diag, upper, rhs, pair: bool = True) -> Layout:
    """The kernel's description of the operands, x being a new
    C-contiguous array of rhs's shape. Coefficients are cast to rhs's
    compute dtype (float32 for bfloat16; no copy when they have it).
    ``pair``: look for an axis of size 2 along which lower, diag and
    upper are broadcast, with lower and upper varying along rows only. An
    operand is copied (expanded to rhs's shape, C-contiguous) only while
    the columns need more than MAX_AXES axes, the one that splits the
    batch most first."""
    n, batch = rhs.shape[0], tuple(rhs.shape[1:])
    shape = (n,) + batch
    m = math.prod(batch)
    if m >= 2 ** 31:
        raise ValueError(f"tridiag: {m} systems exceed the kernel's 2**31")
    ops = {"rhs": rhs}
    cdt = kl.compute_dtype(rhs.dtype)
    for k, a in (("lower", lower), ("diag", diag), ("upper", upper)):
        ops[k] = torch.as_tensor(a).to(cdt)
    xs = _contiguous_strides(shape)
    copied = []
    while True:
        strides = [ops[k].expand(shape).stride() for k in NAMES[:4]] + [xs]
        axes = _axes(strides, batch)
        pair_axis = None
        if pair and all(st[0] == st[2] == 0 for _, st in axes):
            pair_axis = next((k for k, (size, st) in enumerate(axes)
                              if size == 2 and st[1] == 0), None)
        if len(axes) - (pair_axis is not None) <= MAX_AXES:
            break
        k = max((k for k in NAMES[:4] if k not in copied),
                key=lambda k: len(_axes([strides[NAMES.index(k)], xs],
                                        batch)))
        ops[k] = ops[k].expand(shape).contiguous()
        copied.append(k)
    return Layout(n, m, tuple(s[0] for s in strides), tuple(axes),
                  pair_axis, ops, tuple(copied))


def block_size(cols: int, sms: int) -> int:
    """Threads a block: the largest of BLOCKS that still gives every one
    of the `sms` SMs a block, else the smallest. On the H100 (132 SMs)
    the momentum systems (49,536 columns) take 128 (2.9 blocks an SM),
    temperature (16,512) 64 (2.0 an SM); `scripts/probe_k4.py` times the
    others."""
    for b in BLOCKS:
        if -(-cols // b) >= sms:
            return b
    return BLOCKS[-1]


class TridiagSolve:
    """Callable ``(lower, diag, upper, rhs) -> x``, one instance per model
    (its ``launches`` counts the CUDA launches, ``copies`` the operands
    copied for the kernel). CPU tensors take the plain version; a CUDA
    ``rhs`` launches the kernel or raises. ``block`` (threads a block;
    None: ``block_size``) and ``pair`` (solve a broadcast pair with one
    reciprocal a row) set the launch plan; scripts/probe_k4.py times
    others than the defaults."""

    def __init__(self):
        self.block: Optional[int] = None
        self.pair = True
        self._fn = {}
        self._sms = {}
        self.launches = 0
        self.copies = 0

    @staticmethod
    def plain(lower, diag, upper, rhs):
        return thomas_solve(lower, diag, upper, rhs)

    def _bind(self, dtype):
        """(the kernel's entry, its staged_max entry) of one dtype."""
        sfx = kl.suffix(dtype)
        if sfx not in self._fn:
            P, I = ctypes.c_void_p, ctypes.c_int
            I64 = ctypes.POINTER(ctypes.c_int64)
            self._fn[sfx] = (
                kl.bind("tridiag.cu", f"dp_tridiag_{sfx}",
                        [I, ctypes.c_int64, I, I, I64, I64] + [P] * 7),
                kl.bind("tridiag.cu", f"dp_tridiag_{sfx}_staged_max",
                        [I, I, I]))
        return self._fn[sfx]

    def plan(self, lay: Layout, device) -> Tuple[int, bool]:
        """(threads a block, whether a block stages its rows in shared
        memory) of a solve on `device`; a solve not staged needs a
        scratch for c'."""
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
        block = self.block or block_size(lay.cols, self._sms[device])
        smax = self._bind(lay.operands["rhs"].dtype)[1]
        return block, lay.n <= smax(lay.pair, int(lay.row_coefficients),
                                    block)

    def __call__(self, lower, diag, upper, rhs):
        if rhs.device.type == "cpu":
            return self.plain(lower, diag, upper, rhs)
        if rhs.device.type != "cuda":
            raise ValueError(f"tridiag: rhs is on {rhs.device}")
        n, m = rhs.shape[0], rhs[0].numel()
        if n < 1 or m < 1:
            raise ValueError(f"tridiag: empty system {tuple(rhs.shape)}")
        fn = self._bind(rhs.dtype)[0]
        lay = layout(lower, diag, upper, rhs, pair=self.pair)
        for k, t in lay.operands.items():
            if t.device != rhs.device:
                raise ValueError(f"tridiag: {k} is on {t.device}, rhs on "
                                 f"{rhs.device}")
        dev = rhs.device
        block, staged = self.plan(lay, dev)
        cdt = kl.compute_dtype(rhs.dtype)
        x = torch.empty(rhs.shape, dtype=cdt, device=dev)
        scratch = (None if staged else
                   torch.empty((n, lay.cols), dtype=cdt, device=dev))
        sizes = (ctypes.c_int64 * MAX_AXES)(*(s for s, _ in lay.columns()))
        desc = (ctypes.c_int64 * (5 * len(NAMES)))(
            *(v for k in NAMES for v in lay.desc(k)))
        ops = dict(lay.operands, x=x)
        kl.check(fn(n, lay.cols, lay.pair, block, sizes, desc,
                    *(kl.ptr(ops[k]) for k in NAMES),
                    None if scratch is None else kl.ptr(scratch),
                    kl.stream_of(rhs)), "tridiag kernel")
        self.launches += 1
        self.copies += len(lay.copied)
        return x
