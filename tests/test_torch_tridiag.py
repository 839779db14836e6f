"""K4's operand layout (ops/tridiag.py ``layout``), on CPU: the kernel
reads every operand as the caller passes it, through a row stride and
the strides of at most three column axes plus an optional pair axis.

  * Each operand's description, rebuilt with ``torch.as_strided``, equals
    ``a.expand(rhs.shape).reshape(n, m)``: once over the merged batch
    axes, and once as the kernel walks it (three column axes, then the
    pair), with the columns ordered by x's own description.
  * The direct Helmholtz solvers' operands need no copy, and their
    real/imaginary axis becomes the pair axis.
The kernel's arithmetic is held against the plain version on the card
(tests/test_torch_kernels.py, chip_smoke.py); its plain version against
the JAX package in tests/test_torch_helmholtz.py.
"""

import math

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.grid.factory import make_shell
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.solvers.helmholtz import ShellHelmholtzDirect

AS, NEU = BC.ANTISYM, BC.NEUMANN
SPECS = {"momentum": [BCSpec(AS, AS), BCSpec(AS, NEU), BCSpec(AS, NEU)],
         "temperature": [BCSpec(AS, NEU)]}


def _direct_systems(field, shape=(4, 8, 16)):
    sol = ShellHelmholtzDirect(make_shell(*shape, 1.0, 3.0), SPECS[field],
                               dtype=np.float64)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (len(SPECS[field]),) + shape))
    return sol.systems(b, 0.037)


def _rand(*shape):
    return torch.as_tensor(np.random.default_rng(sum(shape)).random(shape))


def _case(name):
    """(lower, diag, upper, rhs), the pair axis's size expected with
    pair=True (1: none), and the operands expected to be copied with
    pair=True and with pair=False."""
    if name in ("momentum", "temperature"):
        return _direct_systems(name), 2, ((), ())
    if name == "momentum, diag transposed":
        low, diag, up, rhs = _direct_systems("momentum")
        # the same values, (lat, lon-mode) strides swapped: four axes,
        # three of them columns (four without the pair: diag copied)
        diag = diag.transpose(2, 4).contiguous().transpose(2, 4)
        return (low, diag, up, rhs), 2, ((), ("diag",))
    if name == "spectral (nr, m, 1, nm)":
        n, ml, nm = 4, 6, 9
        return (_rand(n, 1, 1, 1), _rand(n, ml, 1, nm), _rand(n, 1, 1, 1),
                _rand(n, ml, 2, nm)), 2, ((), ())
    if name == "full (n, m)":
        return tuple(_rand(5, 37) for _ in range(4)), 1, ((), ())
    if name == "scalar per row, odd m":
        return (_rand(6, 1, 1), _rand(6, 3, 7), _rand(6, 1, 1),
                _rand(6, 3, 7)), 1, ((), ())
    if name == "scalar for every system":
        return (torch.tensor(0.25, dtype=torch.float64), _rand(7, 1, 1),
                _rand(7, 1, 1), _rand(7, 5, 3)), 1, ((), ())
    if name == "no single description":
        # diag's axes in reverse order, lower and upper broadcast
        # differently: more than three column axes until copies
        rhs = _rand(5, 2, 3, 4, 5)
        diag = _rand(5, 5, 4, 3, 2).permute(0, 4, 3, 2, 1)
        return (_rand(5, 1, 3, 1, 5), diag, _rand(1, 2, 1, 4, 1),
                rhs), 1, (("lower", "diag", "upper"),) * 2
    raise KeyError(name)


CASES = ("momentum", "temperature", "momentum, diag transposed",
         "spectral (nr, m, 1, nm)", "full (n, m)", "scalar per row, odd m",
         "scalar for every system", "no single description")


def _rebuild(t, size, stride):
    return torch.as_strided(t, size, stride, t.storage_offset())


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_layout_rebuilds_operands(case, pair):
    ops4, want_pair, copied = _case(case)
    rhs = ops4[3]
    n, m = rhs.shape[0], rhs[0].numel()
    lay = k4.layout(*ops4, pair=pair)
    assert (lay.n, lay.m) == (n, m)
    assert lay.pair == (want_pair if pair else 1)
    assert lay.copied == copied[0 if pair else 1]
    assert len(lay.columns()) == k4.MAX_AXES
    assert lay.cols * lay.pair == m
    ops = dict(zip(k4.NAMES, ops4))
    # the merged axes, in the batch's C order
    sizes = (n,) + tuple(s for s, _ in lay.axes)
    for i, k in enumerate(k4.NAMES[:4]):
        want = ops[k].expand(rhs.shape).reshape(n, m)
        got = _rebuild(lay.operands[k], sizes, (lay.rows[i],) + tuple(
            st[i] for _, st in lay.axes)).reshape(n, m)
        assert torch.equal(got, want), k
        if k not in lay.copied:       # the caller's own tensor
            assert lay.operands[k].data_ptr() == torch.as_tensor(
                ops[k]).data_ptr()
    # as the kernel walks them: column (i0, i1, i2), then the pair; the
    # system of each is where x's description puts it
    walk = tuple(s for s, _ in lay.columns()) + (lay.pair,)
    xd = lay.desc("x")
    assert xd[0] == m
    order = _rebuild(torch.arange(m), walk, xd[1:]).reshape(-1)
    assert torch.equal(order.sort().values, torch.arange(m))
    for k in k4.NAMES[:4]:
        d = lay.desc(k)
        got = _rebuild(lay.operands[k], (n,) + walk, d).reshape(n, m)
        want = ops[k].expand(rhs.shape).reshape(n, m)[:, order]
        assert torch.equal(got, want), k


@pytest.mark.parametrize("field", ["momentum", "temperature"])
def test_direct_solver_operands_need_no_copy(field):
    """At the bench's widths in the lat and lon axes (and 4 levels): no
    operand copied, lower and upper one value a row, the pair axis the
    real/imaginary one, and one thread per pair in two column axes."""
    low, diag, up, rhs = _direct_systems(field, (4, 128, 256))
    lay = k4.layout(low, diag, up, rhs)
    assert lay.copied == () and lay.pair == 2
    assert rhs.shape[3] == 2 and lay.desc("rhs")[4] == rhs.stride(3)
    for k in ("lower", "upper"):
        assert lay.desc(k)[1:] == (0, 0, 0, 0)
    assert lay.desc("diag")[4] == 0
    assert lay.cols == rhs[0].numel() // 2
    # C and lat merge into one column axis
    assert [s for s, _ in lay.columns()] == [1, rhs.shape[1] * 128, 129]
    assert k4.values_moved(low, diag, up, rhs) == (
        2 * rhs.numel() + rhs.numel() // 2 + 2 * rhs.shape[0])


@pytest.mark.parametrize("cols,want", [(49536, 128), (16512, 64),
                                       (10 ** 6, 128), (4000, 32), (1, 32)])
def test_block_size_fills_the_card(cols, want):
    """The bench's column counts (momentum, temperature) and others on
    132 SMs: the largest block that gives every SM one, else the
    smallest."""
    b = k4.block_size(cols, 132)
    assert b == want and b in k4.BLOCKS
    assert b == k4.BLOCKS[-1] or math.ceil(cols / b) >= 132
