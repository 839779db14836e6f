"""The launch plans of the Richardson kernel (ops/richardson.py): K1o's
operands plan, its tile chosen from the shard and the card, against
K1's fixed whole-grid plan, and the shared memory of both layouts. Pure
Python; no card needed."""

import numpy as np
import pytest

from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import richardson as k1

# shards: the bench's 2 x 2 and 2 x 4 (32 x 128 x 256), ragged depths,
# shards narrower than a tile, K1's whole grid
SHAPES = [(32, 64, 128), (32, 64, 64), (25, 64, 128), (9, 64, 128),
          (33, 64, 128), (6, 10, 18), (6, 10, 9), (8, 8, 36),
          (32, 128, 256)]
# (SMs, resident blocks an SM by registers): the H100 SXM, a card holding
# one block an SM, a card of 114 SMs, a small one
CARDS = [(132, 2), (132, 1), (114, 2), (8, 1)]
ITEMSIZES = [4, 8]


def _weighted_rounds(shape, tile, halo, itemsize, card):
    """Rounds of resident slots times the cells of a block's x box, or
    None where the tile's block does not fit the card."""
    sms, per_sm = card
    smem = k1.shared_bytes(tile, halo, itemsize, operands=True)
    res = k1.resident_per_sm(smem, per_sm)
    if smem > kl.SMEM_PER_BLOCK - k1.SMEM_STATIC or res < 1:
        return None
    blocks = np.prod([-(-n // a) for n, a in zip(shape, tile)])
    return -(-int(blocks) // (sms * res)) * int(
        np.prod([a + 2 * halo for a in tile]))


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_operands_plan_covers_every_cell_once(shape, card, itemsize):
    """Block b of the launch (csrc/richardson.cu's decode: lon tile
    fastest, then lat tile, then radial tile) owns the cells of one tile
    clipped to the shard, and runs all four channels on them: every owned
    cell once, the ragged last tiles included; one pass of halo
    max(iters) + 1."""
    ps = k1.plan_operands(shape, *card, itemsize, 1, 1)
    assert ps.halo == 2 and (ps.n_u, ps.n_T) == (1, 1)
    nbr, nbl, nbo = ps.grid
    RB, TL, TO = ps.tile
    assert all(1 <= t <= n for t, n in zip(ps.tile, shape))
    assert ps.grid == tuple(-(-n // t) for n, t in zip(shape, ps.tile))
    count = np.zeros(shape, np.int32)
    for blk in range(ps.n_blocks):
        bo, rest = blk % nbo, blk // nbo
        bl, br = rest % nbl, rest // nbl
        count[br * RB:(br + 1) * RB, bl * TL:(bl + 1) * TL,
              bo * TO:(bo + 1) * TO] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_operands_plan_takes_the_fewest_weighted_rounds(shape, card,
                                                        itemsize):
    """No tile of TILES that fits makes fewer rounds of resident slots
    weighted by a block's x box, and none as few is larger; the plan's
    shared memory is its tile's."""
    ps = k1.plan_operands(shape, *card, itemsize, 1, 1)
    best = _weighted_rounds(shape, ps.tile, 2, itemsize, card)
    assert best is not None
    assert ps.smem_bytes == k1.shared_bytes(ps.tile, 2, itemsize,
                                            operands=True)
    for t in k1.TILES:
        tile = tuple(min(a, n) for a, n in zip(t, shape))
        w = _weighted_rounds(shape, tile, 2, itemsize, card)
        if w is None:
            continue
        assert w >= best
        if w == best:
            assert np.prod(tile) <= np.prod(ps.tile)


@pytest.mark.parametrize("shape,itemsize,tile,blocks", [
    ((32, 64, 128), 4, (8, 8, 16), 256),    # 2 x 2 shard, f32
    ((32, 64, 64), 4, (4, 8, 16), 256),     # 2 x 4 shard, f32
    ((32, 64, 128), 8, (8, 8, 16), 256),    # f64
    ((32, 64, 64), 8, (4, 8, 16), 256),
])
def test_operands_plan_at_the_bench_shards(shape, itemsize, tile, blocks):
    """On an H100 (132 SMs, 2 blocks an SM by registers) the bench's
    shards take one round of 256 blocks of the 264 slots: (8, 8, 16) on
    the 2 x 2 shard, (4, 8, 16) on the 2 x 4 shard, in f32 and f64 (the
    sweep's fastest, or within 1.4% of it: PERF.md §6), where K1's
    (8, 8, 32) gives 128 / 64 blocks."""
    ps = k1.plan_operands(shape, 132, 2, itemsize, 1, 1)
    assert (ps.tile, ps.n_blocks) == (tile, blocks)
    res = k1.resident_per_sm(ps.smem_bytes, 2)
    assert res == 2 and ps.n_blocks <= 132 * res


def test_operands_plan_at_k1s_grid_is_k1s_tile():
    """The whole 32 x 128 x 256 grid as one shard takes K1's own tile in
    f32, (8, 8, 32), 512 blocks, which K1 takes by measurement."""
    ps = k1.plan_operands((32, 128, 256), 132, 2, 4, 1, 1)
    assert (ps.tile, ps.n_blocks) == ((8, 8, 32), 512)


def test_operands_plan_deeper_halo():
    """Two sweeps (halo 3, the operands mode's GH) still plan one pass on
    a tile that fits, with its rows padded for 16-byte copies."""
    ps = k1.plan_operands((32, 64, 64), 132, 2, 4, 2, 2)
    assert ps.halo == 3
    assert ps.smem_bytes <= kl.SMEM_PER_BLOCK - k1.SMEM_STATIC
    assert ps.smem_bytes == k1.shared_bytes(ps.tile, 3, 4, operands=True)


def test_whole_grid_plan_is_unchanged():
    """K1 and K1u keep their plan: one pass on (8, 8, 32), 512 blocks at
    the bench shape, 86,816 bytes of shared memory in f32."""
    (ps,) = k1.plan((32, 128, 256), 4, 1, 1)
    assert (ps.tile, ps.grid, ps.n_blocks, ps.smem_bytes) == (
        (8, 8, 32), (4, 16, 8), 512, 86816)
    (pu,) = k1.plan((32, 128, 256), 4, 1, 1, track=False)
    assert (pu.tile, pu.n_blocks, pu.halo) == ((8, 8, 32), 512, 2)


@pytest.mark.parametrize("tile,itemsize,whole,ops,resident", [
    ((8, 8, 32), 4, 86816, 88416, 2),
    ((8, 8, 32), 8, 173632, 176832, 1),
    ((8, 8, 16), 4, 51488, 53088, 2),
    ((8, 8, 16), 8, 102976, 106176, 2),
    ((4, 8, 16), 4, 32736, 33696, 2),
    ((4, 8, 16), 8, 65472, 67392, 2),
])
def test_shared_memory_of_both_layouts(tile, itemsize, whole, ops,
                                       resident):
    """K1's layout (boxes as wide as they are) and K1o's (x rows padded to
    16 bytes, level-1 rows one value more in front, the divergence padded
    to 16 bytes): both fit a block's 232,448 - 16 bytes; K1o's a little
    larger, a multiple of 16 bytes, and the resident blocks an SM (at 2
    by registers) those claimed."""
    assert k1.shared_bytes(tile, 2, itemsize) == whole
    got = k1.shared_bytes(tile, 2, itemsize, operands=True)
    assert got == ops and got % 16 == 0 and got > whole
    assert got <= kl.SMEM_PER_BLOCK - k1.SMEM_STATIC
    assert k1.resident_per_sm(got, 2) == resident
