"""The launch plans of the forcing kernels (ops/forcing.py): K2o's and
K2mo's operands plan, chosen from the shard and the card, against K2's
fixed plan, and the shared memory of the operands layout. Pure Python;
no card needed."""

import numpy as np
import pytest

from dycoreplanet_tpu_torch.ops import forcing as k2

# shards: the bench's 2 x 2 and 2 x 4 (32 x 128 x 256), depths whose last
# chunk is short, shards narrower than a tile, K2's whole grid
SHAPES = [(32, 64, 128), (32, 64, 64), (25, 64, 128), (9, 64, 128),
          (33, 64, 128), (6, 10, 18), (6, 10, 9), (8, 8, 36),
          (32, 128, 256)]
# (SMs, resident blocks an SM): the H100 SXM in f32 and f64, a card of
# 114 SMs, a small one
CARDS = [(132, 2), (132, 1), (114, 2), (8, 1)]
# the H100's shared memory an SM, and what the driver keeps of it a block
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024


def _blocks(grid):
    return grid[0] * grid[1] * grid[2]


def _rounds(shape, rs, slots):
    """Planes a resident slot marches under chunk rs: rounds of blocks
    times the chunk."""
    nr, nl, no = shape
    tiles = -(-nl // k2.TILE[0]) * -(-no // k2.TILE[1])
    return -(-(-(-nr // rs) * tiles) // slots) * rs


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_operands_plan_covers_every_plane_and_tile_once(shape, card):
    """Block b of the launch (csrc/forcing.cu's decode: lon tile fastest,
    then lat tile, then radial chunk) owns planes [c RS, min(nr, (c + 1)
    RS)) of one tile: every (plane, lat, lon) cell once, the short last
    chunk included."""
    rs, (nc, nbl, nbo) = k2.plan_operands(shape, *card)
    nr = shape[0]
    assert 1 <= rs <= nr and nc == -(-nr // rs)
    TL, TO = k2.TILE
    count = np.zeros(shape, np.int32)
    for blk in range(nc * nbl * nbo):
        bo, rest = blk % nbo, blk // nbo
        bl, bc = rest % nbl, rest // nbl
        count[bc * rs:min(nr, (bc + 1) * rs), bl * TL:(bl + 1) * TL,
              bo * TO:(bo + 1) * TO] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_operands_plan_takes_the_fewest_rounds(shape, card):
    """No other chunk makes a slot march fewer planes, and none as few is
    longer (fewer prologues)."""
    rs = k2.plan_operands(shape, *card)[0]
    slots = card[0] * card[1]
    best = _rounds(shape, rs, slots)
    for r in range(1, shape[0] + 1):
        assert _rounds(shape, r, slots) >= best
        if r > rs:
            assert _rounds(shape, r, slots) > best


@pytest.mark.parametrize("shape,card,rs,blocks", [
    ((32, 64, 128), (132, 2), 4, 256),      # 2 x 2 shard, f32
    ((32, 64, 64), (132, 2), 2, 256),       # 2 x 4 shard, f32
    ((32, 64, 128), (132, 1), 8, 128),      # f64: one block an SM
    ((32, 64, 64), (132, 1), 4, 128),
    ((8, 64, 128), (132, 2), 1, 256),       # fewer pairs than slots
    ((6, 10, 18), (132, 2), 1, 12),
])
def test_operands_plan_at_the_bench_shards(shape, card, rs, blocks):
    """On an H100 (132 SMs; 2 resident blocks in f32, 1 in f64) the
    bench's shards take one round of blocks: 256 of the 264 f32 slots
    (one more chunk would start a second round), RS 4 and 2 (PERF.md §6:
    faster than the grids of 512 blocks); a shard with fewer (plane,
    tile) pairs than slots takes one plane a block."""
    got_rs, grid = k2.plan_operands(shape, *card)
    assert (got_rs, _blocks(grid)) == (rs, blocks)
    slots = card[0] * card[1]
    assert _blocks(grid) <= slots
    nr, nl, no = shape
    tiles = grid[1] * grid[2]
    assert rs == 1 or -(-nr // (rs - 1)) * tiles > slots


def test_operands_plan_at_k2s_grid_is_k2s_plan():
    """The whole 32 x 128 x 256 grid as one shard takes K2's own chunk of
    16 planes (256 blocks), which PR 3 chose by measurement."""
    assert k2.plan_operands((32, 128, 256), 132, 2) == k2.plan((32, 128,
                                                                256))


def test_local_plan_is_unchanged():
    """K2 and K2m keep their fixed plan: 16 planes a block, 256 blocks at
    the bench shape."""
    rs, grid = k2.plan((32, 128, 256))
    assert (rs, grid, _blocks(grid)) == (16, (2, 16, 8), 256)
    assert k2.plan((6, 20, 36)) == (6, (1, 3, 2))


@pytest.mark.parametrize("advect_T,f32,f64", [(True, 33088, 66176),
                                              (False, 27040, 54080)])
def test_operands_layout_shared_memory(advect_T, f32, f64):
    """The operands layout's rows are TO + 8 wide, each region rounded to
    16 bytes: a few KB more than K2's (30,856 / 25,192 bytes in f32),
    and two blocks still fit an SM in f32 (its registers allow two)."""
    assert k2.shared_bytes(4, advect_T, operands=True) == f32
    assert k2.shared_bytes(8, advect_T, operands=True) == f64
    assert 2 * (f32 + SMEM_RESERVED) <= SMEM_PER_SM
    assert f32 > k2.shared_bytes(4, advect_T)
    assert f32 % 16 == 0 and f64 % 16 == 0
