"""Kernel 9's launch plan (``ops/temporal_attention.py::launch_plan``), on
the CPU.

The wrapper picks the tile (L locations x HB heads), the ring's stages, the
consumer warps, the persistent grid and the shared memory without the card;
these tests hold that plan to what ``csrc/temporal_attention.cu`` takes
(232,448 bytes of shared memory a block on the H100, TMA boxes of at most
256 a dim) at the packed configuration's five frame-attention sites (b = 2
for CFG, 17 frames, d = 64), at JAX's ragged test shapes and at the edges
of the kernel's reach (f = 48 and 128, d = 40, 128, 160 and 256), and check
that the tiles and their items cover every (batch, location, head) and
query row exactly once.
"""

import itertools
import re

import pytest

SMEM = 232448
# (s, h) of the packed request's sites (chip_smoke.PACKED_SITES)
PACKED_SITES = ((4096, 8), (4096, 5), (1024, 10), (256, 20), (64, 20))
SITES = [(2, 17, s, h, 64) for s, h in PACKED_SITES]
# JAX's ragged test shapes (tests/test_torch_port_packed.py), then the reach
REACH = [(1, 17, 33, 2, 64), (2, 14, 40, 1, 32), (2, 2, 40, 1, 32), (2, 17, 40, 3, 40),
         (1, 48, 24, 2, 64), (1, 128, 30, 2, 64), (2, 17, 100, 4, 128), (2, 17, 100, 3, 160),
         (1, 17, 70, 2, 256), (1, 128, 9, 2, 256), (1, 48, 51, 2, 40)]


def _one_stage(f: int, d: int) -> bool:
    """Where two stages of one (location, head) do not fit the block."""
    return (f > 88 and d > 128) or (f > 64 and d > 192)


@pytest.mark.parametrize("b,f,s,h,d", SITES + REACH)
def test_plan_fits_the_card_and_the_kernel(b, f, s, h, d):
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    p = ta.launch_plan(b, f, s, h, d, sms=132)
    L, HB, stages, warps = p["L"], p["HB"], p["stages"], p["warps"]
    assert h % HB == 0 and 1 <= L <= s
    # a stage: q, k and v, HB·⌈d/64⌉ chunks of L·f rows of 128 bytes each,
    # rounded up to an 8-row swizzle atom, and two mbarriers; 1024 bytes of
    # alignment; a 32-row x 128-byte staging buffer a consumer warp
    chunk = -(-L * f // 8) * 1024
    assert p["smem"] == 1024 + stages * (3 * HB * -(-d // 64) * chunk + 16) + warps * 32 * 128
    assert p["smem"] <= SMEM
    assert 1 <= stages <= ta.MAX_STAGES and (stages >= 2) == (not _one_stage(f, d))
    # every consumer warp meets every tile: no more warps than items
    items = L * HB * (1 if f <= 32 else -(-f // 16))
    assert p["items"] == items and 1 <= warps <= min(ta.MAX_WARPS, items)
    assert p["tiles"] == b * -(-s // L) * (h // HB)
    assert 1 <= p["grid"] <= min(132, p["tiles"])
    # TMA boxes: loads 64 x f x L x 1, stores {64, 32, 16, 8} x (f or 16) x 1 x 1
    for box in ((64, f, L, 1), (64, f if f <= 32 else 16, 1, 1)):
        assert all(1 <= x <= 256 for x in box)


@pytest.mark.parametrize("b,f,s,h,d", SITES)
def test_plan_at_the_packed_sites(b, f, s, h, d):
    """At every site of the packed request: a ring of at least two tiles in
    flight beside the one computing, eight consumer warps, one block a SM."""
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    p = ta.launch_plan(b, f, s, h, d, sms=132)
    assert p["stages"] >= 3 and p["warps"] == 8 and p["grid"] == 132
    assert (p["L"], p["HB"]) == (8, 1)


@pytest.mark.parametrize("b,f,s,h,d", SITES[3:] + REACH)
def test_tiles_and_items_cover_every_problem_once(b, f, s, h, d):
    """The persistent blocks' tiles (tile = block + t·grid) cover every
    tile once; the tiles every (batch, location, head) once; a tile's items
    every 16-row query tile of its (location, head)s once."""
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    p = ta.launch_plan(b, f, s, h, d, sms=132)
    L, HB, grid, tiles = p["L"], p["HB"], p["grid"], p["tiles"]
    walked = sorted(blk + t * grid for blk in range(grid)
                    for t in range(-(-tiles // grid)) if blk + t * grid < tiles)
    assert walked == list(range(tiles))
    lblocks, hblocks = -(-s // L), h // HB
    seen = {}
    for tile in range(tiles):
        hk, rest = tile % hblocks, tile // hblocks
        s0, bi = (rest % lblocks) * L, rest // lblocks
        for l, hb in itertools.product(range(L), range(HB)):
            if s0 + l < s:
                key = (bi, s0 + l, hk * HB + hb)
                seen[key] = seen.get(key, 0) + 1
    assert seen == {key: 1 for key in itertools.product(range(b), range(s), range(h))}
    mt = -(-f // 16)
    covered = []
    for it in range(p["items"]):
        if f <= 32:   # both query tiles of (location, head) it
            covered += [(it, 16 * m) for m in range(mt)]
        else:         # query tile it % mt of (location, head) it // mt
            covered.append((it // mt, 16 * (it % mt)))
    assert sorted(covered) == [(u, 16 * m) for u in range(L * HB) for m in range(mt)]


@pytest.mark.parametrize("f,d", [(1, 64), (129, 64), (17, 36), (17, 0), (17, 264)])
def test_plan_refuses_shapes_the_kernel_does_not_take(f, d):
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    with pytest.raises(ValueError):
        ta.launch_plan(2, f, 64, 2, d)


def test_one_stage_only_where_two_do_not_fit():
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    for f in range(2, 129, 7):
        for d in range(8, 257, 24):
            p = ta.launch_plan(1, f, 10, 1, d)
            assert (p["stages"] >= 2) == (not _one_stage(f, d)), (f, d, p)


def test_plan_matches_the_kernel():
    """The plan's constants and shared-memory formula are the source's; the
    loads and stores are TMA on a strided map, the products mma.sync fed by
    ldmatrix, with no cp.async or scalar gathers left."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    text = (cuda_lib.CSRC / "temporal_attention.cu").read_text()
    assert re.search(r"constexpr int MAX_WARPS = (\d+);", text).group(1) == str(ta.MAX_WARPS)
    assert "constexpr int STAGING = 32 * 128;" in text and ta.STAGING == 32 * 128
    assert "return (L * f + 7) / 8 * 1024;" in text
    assert ("return 1024 + stages * 3 * chunks * region_bytes(L, f) + warps * STAGING + "
            "16 * stages;") in text
    assert "make_map_strided" in text and "tma_load_4d" in text and "tma_store_4d" in text
    assert "ldmatrix" in text and ".trans" in text and "mma_16816" in text
    assert "cp_async" not in text and "wgmma_" not in text
