"""The tiled K1 and K2 kernels' host side, on CPU:

  * the launch plans (ops/richardson.py ``plan``, ops/forcing.py
    ``plan``) own every cell exactly once and fit a block's shared
    memory, with a halo of max(iters) + 1 for K1;
  * K1's folded lon-invariant tables equal the JAX Pallas kernel's own
    ``HelmholtzRichardsonPallas._chans64`` in f64;
  * the operator the K1 kernel evaluates from those tables, in
    conductance form (zeroed wall conductances, the ANTISYM ghost folded
    into a diagonal term, zero-area pole faces), is the JAX package's
    ghost-based ``weak_laplacian`` with each channel's homogeneous BCs,
    to 1e-12 in f64.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dycoreplanet_tpu.ops import stencil as j_st
from dycoreplanet_tpu.ops.pallas_richardson import make_richardson
from dycoreplanet_tpu_torch.ops import forcing as k2
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import richardson as k1
from tests.test_torch_kernels import _models

SHAPES = [(32, 128, 256), (6, 20, 36), (4, 8, 16), (8, 16, 32), (5, 12, 64),
          (3, 2, 4)]
PAIRS = [(1, 1), (2, 1), (1, 2), (1, 3), (3, 1), (2, 2), (3, 3)]


def _owned_by_k1(shape, ps):
    """How often each cell is owned by a block of one K1 pass, with the
    kernel's block order (lon tiles fastest, then lat, then radial)."""
    count = np.zeros(shape, np.int32)
    RB, TL, TO = ps.tile
    nbr, nbl, nbo = ps.grid
    for blk in range(ps.n_blocks):
        bo, rest = blk % nbo, blk // nbo
        bl, br = rest % nbl, rest // nbl
        count[br * RB:(br + 1) * RB, bl * TL:(bl + 1) * TL,
              bo * TO:(bo + 1) * TO] += 1
    return count


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("iters", PAIRS)
def test_richardson_plan_covers_every_cell_once(shape, itemsize, iters):
    passes = k1.plan(shape, itemsize, *iters)
    assert len(passes) == 1
    ps = passes[0]
    assert (ps.n_u, ps.n_T) == iters
    assert ps.halo == max(iters) + 1
    assert ps.smem_bytes == k1.shared_bytes(ps.tile, ps.halo, itemsize)
    assert ps.smem_bytes <= kl.SMEM_PER_BLOCK - 16
    assert all(t <= n for t, n in zip(ps.tile, shape))
    assert (_owned_by_k1(shape, ps) == 1).all()


@pytest.mark.parametrize("iters,limit", [((3, 3), 20000), ((1, 3), 9000),
                                         ((3, 1), 9000), ((4, 2), 30000)])
def test_richardson_plan_groups_sweeps_when_shared_memory_is_short(iters,
                                                                  limit):
    """A halo that no tile can hold runs as several passes whose sweeps
    add up to the iteration counts, each within the limit."""
    shape = (6, 20, 36)
    passes = k1.plan(shape, 8, *iters, smem_limit=limit)
    assert len(passes) > 1
    assert sum(p.n_u for p in passes) == iters[0]
    assert sum(p.n_T for p in passes) == iters[1]
    for ps in passes:
        assert ps.halo == max(ps.n_u, ps.n_T) + 1
        assert ps.smem_bytes <= limit
        assert (_owned_by_k1(shape, ps) == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_forcing_plan_covers_every_cell_once(shape, itemsize):
    rs, (nc, nbl, nbo) = k2.plan(shape)
    TL, TO = k2.TILE
    count = np.zeros(shape, np.int32)
    for blk in range(nc * nbl * nbo):
        bo, rest = blk % nbo, blk // nbo
        bl, bc = rest % nbl, rest // nbl
        count[bc * rs:(bc + 1) * rs, bl * TL:(bl + 1) * TL,
              bo * TO:(bo + 1) * TO] += 1
    assert (count == 1).all()
    assert k2.shared_bytes(itemsize) <= kl.SMEM_PER_BLOCK


@pytest.mark.parametrize("iters,iters_u", [(1, 1), (2, 0)])
def test_richardson_tables_match_pallas_chans64(iters, iters_u):
    jm, tm = _models("float64", (8, 16, 32), iters=iters, iters_u=iters_u)
    kern = make_richardson(jm.geo, jm, interpret=True, use_pallas=True)
    assert kern is not None
    want = np.asarray(kern._chans64)
    got = tm._richardson.tables64
    assert got.shape == (17,) + want.shape[1:]
    np.testing.assert_allclose(got[:15], want, rtol=1e-15, atol=0)


def _table_laplacian(tab, v, channel):
    """L v from the K1 tables in conductance form: sum over faces of
    c (v_nbr - v) with the wall conductances zeroed and cells past a wall
    or a pole taken as 0, plus the folded wall term Dl v."""
    cr_lo, cr_hi, cl_lo, cl_hi, co = (tab[c][..., None] for c in range(1, 6))
    dl = tab[13 if channel == 0 else 14][..., None]
    z_r = np.zeros_like(v[:1])
    z_l = np.zeros_like(v[:, :1])
    v_rm = np.concatenate([z_r, v[:-1]], axis=0)
    v_rp = np.concatenate([v[1:], z_r], axis=0)
    v_lm = np.concatenate([z_l, v[:, :-1]], axis=1)
    v_lp = np.concatenate([v[:, 1:], z_l], axis=1)
    acc = cr_lo * (v_rm - v) + cr_hi * (v_rp - v)
    acc = acc + cl_lo * (v_lm - v) + cl_hi * (v_lp - v)
    acc = acc + co * ((np.roll(v, 1, axis=2) - v)
                      + (np.roll(v, -1, axis=2) - v))
    return acc + dl * v


@pytest.mark.parametrize("channel", [0, 1, 2, 3])
def test_table_operator_matches_weak_laplacian(channel):
    jm, tm = _models("float64", (6, 12, 16))
    v = np.random.default_rng(channel).standard_normal(jm.geo.cell_shape)
    specs = jm.u_specs[channel] if channel < 3 else jm.T_specs_hom
    want = np.asarray(j_st.weak_laplacian(jm.geo, jnp.asarray(v), specs))
    got = _table_laplacian(tm._richardson.tables64, v, channel)
    assert float(np.max(np.abs(got - want))) <= \
        1e-12 * float(np.max(np.abs(want)))
