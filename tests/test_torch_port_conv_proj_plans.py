"""Kernels 8 and 4 on the CPU: their launch plans against what
``csrc/spatial_conv.cu`` and ``csrc/gemm.cuh``'s slab form take, at every
main-path site and at the JAX package's test shapes.

- ``ops/spatial_conv.py::launch_plan`` (kernel 8's implicit GEMM) and
  ``ops/proj_residual.py::launch_plan`` (kernel 4) pick the tile width,
  ring depth, grid and shared memory without the card; these tests hold
  them to 232,448 bytes of shared memory a block on the H100, to the tile
  widths the C entry points dispatch on (read from the sources, as
  ``test_torch_port_temporal_plans.py`` does for kernel 3), and to the
  sub-tile rules (64 pixels of one image; 64 rows of one slab);
- the sites are those the opt-in request's CFG forward launches (n = 34 =
  2 × 17 frames; ``utils/kernel_sites``): 18 distinct resnet stages for
  kernel 8, 5 projections for kernel 4;
- both sources run TMA and wgmma, and the profiler counts their launches
  in their kernels' groups.
"""

import re

import pytest

from animate_anything_tpu_torch.utils.kernel_sites import PROJ_SITES as PROJ_FORWARD
from animate_anything_tpu_torch.utils.kernel_sites import SPATIAL_CONV_SITES as SPATIAL_SITES

SMEM = 232448
# (n, H, W, cin, cout): JAX's test shapes (tests/test_torch_port_spatial_conv.py)
# and edges: W > 64 (a sub-tile is a 64-pixel run of one row), W not a power
# of two, one image.
SPATIAL_TEST_SHAPES = [(2, 16, 16, 64, 48), (2, 16, 16, 64, 64), (2, 8, 8, 128, 128),
                       (2, 8, 8, 32, 48), (4, 8, 8, 32, 64), (1, 5, 100, 32, 64),
                       (2, 7, 24, 48, 40), (1, 1, 1, 16, 8)]

# (n, s, k, c): kernel 4's five sites a CFG forward (transformer_in 512 → 320,
# then the spatial and temporal transformers' proj_out at each level) and the
# JAX test shapes (tests/test_torch_port_ops.py): ragged s, s = 64, k ≠ c.
PROJ_SITES = [(34, s, k, c) for s, k, c, _ in PROJ_FORWARD]
PROJ_TEST_SHAPES = [(3, 32, 64, 128), (3, 32, 96, 128), (3, 100, 64, 128), (3, 64, 64, 128),
                    (2, 512, 32, 32), (2, 4, 16, 8)]


def test_the_sites_are_the_opt_in_forward():
    """44 resnet stages a CFG forward (1100 launches a 25-step request), as
    the UNet's 4 + 4 + 4 + 2 down, 2 mid and 3 × 4 up resnets give, and 33
    projections (825 a request)."""
    assert sum(site[-1] for site in SPATIAL_SITES) == 44
    assert len({site[:5] for site in SPATIAL_SITES}) == len(SPATIAL_SITES) == 18
    assert sum(site[-1] for site in PROJ_FORWARD) == 33


# ---- kernel 8 --------------------------------------------------------------------

def _check_spatial_plan(n, h, w, cin, cout):
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    plan = sc.launch_plan(n, h, w, cin, cout, sms=132)
    bn, stages = plan["bn"], plan["stages"]
    nb, nacc = sc.TILE_WIDTHS[bn]
    assert bn == nb * nacc
    # ring: A (two 64-pixel sub-tiles of 64 bf16 channels), B (bn x 64 bf16),
    # a full barrier and a done-counter a stage past a 1024-byte pad; no
    # output tile
    assert plan["smem"] == 1024 + stages * (128 * 128 + bn * 128 + 16)
    # one accumulator: two blocks a SM, each in half the SM's shared memory
    blocks = 2 if nacc == 1 else 1
    assert plan["blocks"] == blocks
    fit = min(SMEM, sc.SM_SMEM // blocks - 1024)
    assert 2 <= stages <= sc.MAX_STAGES and plan["smem"] <= fit
    assert sc._smem(bn, stages + 1) > fit or stages == sc.MAX_STAGES
    # a sub-tile: TR whole rows of TW = W up to a power of two (≤ 64) pixels
    tw, tr = plan["tw"], plan["tr"]
    assert tw * tr == 64 and tw & (tw - 1) == 0
    assert tw >= w or tw == 64
    assert tw < 2 * w or tw == 1
    assert plan["subs"] == n * -(-h // tr) * -(-w // tw)
    assert plan["tiles"] == -(-plan["subs"] // 2) * -(-cout // bn)
    assert 1 <= plan["grid"] <= min(blocks * 132, plan["tiles"])
    assert plan["k_steps"] == 9 * -(-cin // 64)
    return plan


@pytest.mark.parametrize("hw,cin,cout,extra,residual,count", SPATIAL_SITES)
def test_spatial_conv_plan_fits_the_card_at_every_site(hw, cin, cout, extra, residual, count):
    _check_spatial_plan(34, hw, hw, cin, cout)


@pytest.mark.parametrize("n,h,w,cin,cout", SPATIAL_TEST_SHAPES)
def test_spatial_conv_plan_fits_the_card_at_the_test_shapes(n, h, w, cin, cout):
    _check_spatial_plan(n, h, w, cin, cout)


def test_spatial_conv_plan_at_the_unet_levels():
    """A sub-tile is one 64-pixel row at 64², two rows at 32², four at 16²
    and one whole 8×8 image; 160-column tiles at two blocks a SM where cout
    ≤ 640 (64², 32²), else 256 at one block a SM (at 16², 272 tiles of 320
    would take three waves of 132; at 8², 68 tiles of 320 would leave half
    the SMs idle)."""
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    got = {hw: sc.launch_plan(34, hw, hw, cout, cout) for hw, cout in
           ((64, 320), (32, 640), (16, 1280), (8, 1280))}
    assert {hw: (p["tw"], p["tr"]) for hw, p in got.items()} == {
        64: (64, 1), 32: (32, 2), 16: (16, 4), 8: (8, 8)}
    assert {hw: p["bn"] for hw, p in got.items()} == {64: 160, 32: 160, 16: 256, 8: 256}
    assert {hw: p["blocks"] for hw, p in got.items()} == {64: 2, 32: 2, 16: 1, 8: 1}
    assert got[64]["grid"] == 264 and got[64]["stages"] == 3
    assert got[8]["tiles"] == 17 * 5 and got[8]["subs"] == 34


@pytest.mark.parametrize("cin,cout", [(8, 64), (24, 64), (0, 64), (64, 4), (64, 12)])
def test_spatial_conv_plan_refuses_shapes_the_kernel_does_not_take(cin, cout):
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    with pytest.raises(ValueError):
        sc.launch_plan(2, 8, 8, cin, cout)


def test_spatial_conv_plan_matches_the_kernel_instantiations():
    """The tile widths the plan may pick are the ones the C entry point
    dispatches on (NB columns x NACC accumulators), its shared-memory
    formula is the source's, the A operand arrives by 4-D TMA boxes and
    the products are wgmma, not mma.sync; the wrapper hands the kernel the
    channels_last weight's own memory, with no pack on the call."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    text = (cuda_lib.CSRC / "spatial_conv.cu").read_text()
    cases = {int(bn): (int(nb), int(nacc)) for bn, nb, nacc in
             re.findall(r"case (\d+): return launch<(\d+), (\d+)>", text)}
    assert cases == sc.TILE_WIDTHS
    assert "return 1024 + stages * (STAGE_BYTES + 16); }" in text
    assert "wgmma_ss<NB>" in text and "tma_load_4d(st, &p.act" in text
    assert "__launch_bounds__(CONSUMERS, NACC == 1 ? 2 : 1)" in text
    assert "mma_sync" not in text and "mma.sync" not in text and "ldmatrix" not in text
    wrapper = (cuda_lib.CSRC.parent / "ops" / "spatial_conv.py").read_text()
    assert "wp.data_ptr() != w.data_ptr()" in wrapper and "packed_weight" not in wrapper


# ---- kernel 4 --------------------------------------------------------------------

def _check_proj_plan(n, s, k, c):
    from animate_anything_tpu_torch.ops import geglu
    from animate_anything_tpu_torch.ops import proj_residual as pr

    plan = pr.launch_plan(n, s, k, c, sms=132)
    bn, stages = plan["bn"], plan["stages"]
    assert bn in pr.TILE_WIDTHS
    assert plan["smem"] == geglu._gemm_smem(bn, stages, bn) <= SMEM
    assert 2 <= stages <= pr.MAX_STAGES
    assert geglu._gemm_smem(bn, stages + 1, bn) > SMEM or stages == pr.MAX_STAGES
    # 64-row sub-tiles of each slab, two to a tile
    assert plan["subs"] == n * -(-s // 64)
    assert plan["tiles"] == -(-plan["subs"] // 2) * -(-c // bn)
    assert 1 <= plan["grid"] <= min(132, plan["tiles"])
    return plan


@pytest.mark.parametrize("n,s,k,c", PROJ_SITES + PROJ_TEST_SHAPES)
def test_proj_residual_plan_fits_the_card(n, s, k, c):
    _check_proj_plan(n, s, k, c)


def test_proj_residual_plan_at_the_unet_sites():
    """160-column tiles at c = 320 and 640 (64-column tiles read A five
    times); 256 at c = 1280. At s = 64 the 34 slabs make 17 tiles of 128
    rows: 85 tiles of 256 columns in one wave beat 136 of 160 in two."""
    from animate_anything_tpu_torch.ops import proj_residual as pr

    plans = [pr.launch_plan(*site, sms=132) for site in PROJ_SITES]
    assert [p["bn"] for p in plans] == [160, 160, 160, 256, 256]
    assert plans[-1]["subs"] == 34 and plans[-1]["tiles"] == 85


@pytest.mark.parametrize("k,c", [(4, 64), (64, 4), (64, 12), (0, 64)])
def test_proj_residual_plan_refuses_shapes_the_kernel_does_not_take(k, c):
    from animate_anything_tpu_torch.ops import proj_residual as pr

    with pytest.raises(ValueError):
        pr.launch_plan(2, 64, k, c)


def test_proj_residual_runs_the_slab_form_of_the_shared_gemm():
    """Kernel 4 is ``gemm.cuh``'s persistent TMA + wgmma residual GEMM in its
    slab form under its own owner tag, at the widths its plan picks from;
    the WMMA kernel and its shared epilogue are gone."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import proj_residual as pr

    text = (cuda_lib.CSRC / "proj_residual.cu").read_text()
    gemm = (cuda_lib.CSRC / "gemm.cuh").read_text()
    assert "gemm::gemm_bias_residual_stats<proj_residual>(" in text
    assert "wmma" not in text and "cp_async" not in text
    body = gemm.split("int gemm_bias_residual_stats(", 1)[1]
    widths = {int(bn) for bn in re.findall(r"case (\d+): return launch_gemm<\1, false, Owner, "
                                           r"true>", body)}
    assert widths == set(pr.TILE_WIDTHS)
    assert "struct proj_residual {};" in gemm
    common = (cuda_lib.CSRC / "common.cuh").read_text()
    assert "bias_residual_stats" not in common and "<mma.h>" not in common


def test_profiler_attributes_kernels_8_and_4_to_their_groups():
    from animate_anything_tpu_torch.utils.profiling import kernel_group

    k8, k4 = "spatial_conv (kernel 8)", "proj_residual (kernel 4)"
    assert kernel_group("void aat::(anonymous namespace)::spatial_conv_act_kernel("
                        "const __nv_bfloat16 *, const float *, ...)") == k8
    assert kernel_group("void aat::(anonymous namespace)::spatial_conv_gemm_kernel<128, 2>("
                        "aat::(anonymous namespace)::ConvParams)") == k8
    assert kernel_group("void aat::gemm::tma_gemm_kernel<160, false, aat::proj_residual, "
                        "true>(aat::gemm::GemmParams)") == k4
    assert kernel_group("void aat::gemm::tma_gemm_kernel<160, false, aat::temporal_block, "
                        "false>(aat::gemm::GemmParams)") == "temporal_block (kernel 5)"
