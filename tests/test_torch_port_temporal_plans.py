"""Kernels 3 and 5 on the CPU: their launch plans, kernel 5's reach against
JAX's gate, and kernel 5's stages against the JAX package.

- ``ops/temporal_conv.py::launch_plan`` and ``ops/temporal_block.py::
  launch_plan`` pick tiles, ring depth, grid and shared memory without the
  card; these tests hold them to what ``csrc/temporal_conv.cu`` and
  ``csrc/temporal_block.cu`` take (232,448 bytes of shared memory a block
  on the H100) at the main path's sites (b = 2 for CFG, 17 frames) and at
  the JAX package's test shapes, as ``test_torch_port_geglu_plan.py`` does
  for kernel 2;
- kernel 5's reach (``kernel_ok``, which its wrapper checks before a
  launch) admits every shape JAX's gate ``fused_ok`` admits with a head dim
  up to 256, case by case, and the wrapper raises above;
- kernel 5 runs as three launches (LayerNorm, q/k/v + frame attention,
  out-projection); each stage's plain version is held against JAX's twin
  ``_reference_bfsc`` (fp32, atol 1e-5: the same products summed in
  another order): the LayerNorm through one frame with Wq = Wk = 0 and
  Wv = Wo = I (the softmax over one frame is 1, so the block returns
  LN(x) + x), the attention through Wo = I, bo = 0 (it returns o + x),
  the out-projection through the whole block;
- ``temporal_block_reference`` at 48 frames and d = 40 against the Pallas
  kernel ``_build_bfsc`` in interpret mode, where nblk·p divides s
  (ROADMAP queue 3: its ragged edge block leaks NaN), atol 2e-4 as the JAX
  tests' own for these kernels.
"""

import math
import re

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import n, t
from test_torch_port_temporal_block import _inputs

SMEM = 232448

# (bsz, f, s, cin, cout): the UNet's four temporal-conv sites, then the JAX
# package's test shapes (tests/test_ops.py, the port's tap-conv tests) and
# edges: ragged s, cin % 64 == 32, one frame, cout < 64.
TAP_SHAPES = [(2, 17, 4096, 320, 320), (2, 17, 1024, 640, 640), (2, 17, 256, 1280, 1280),
              (2, 17, 64, 1280, 1280), (2, 5, 24, 128, 128), (2, 4, 16, 64, 64),
              (1, 3, 512, 32, 32), (1, 3, 100, 96, 40), (1, 1, 70, 64, 64)]
# The SVD UNet's four temporal-resnet sites: b = 2 for CFG, 14 frames.
SVD_TAP_SHAPES = [(2, 14, 4096, 320, 320), (2, 14, 1024, 640, 640), (2, 14, 256, 1280, 1280),
                  (2, 14, 64, 1280, 1280)]

# (b, f, s, c, heads): the UNet's five temporal-attention sites, JAX's test
# shapes (tests/test_torch_port_temporal_block.py, tests/test_ops.py) and
# the reach of ``fused_ok``: 48 and 128 frames, d = 40, 72, 128, 256, c = 2048.
BLOCK_SHAPES = [(2, 17, 4096, 512, 8), (2, 17, 4096, 320, 5), (2, 17, 1024, 640, 10),
                (2, 17, 256, 1280, 20), (2, 17, 64, 1280, 20), (2, 17, 120, 128, 2),
                (2, 17, 120, 64, 8), (2, 4, 9, 64, 2), (2, 5, 12, 256, 4), (2, 48, 51, 80, 2),
                (1, 33, 20, 144, 2), (1, 128, 5, 256, 2), (1, 20, 33, 512, 2),
                (1, 8, 16, 2048, 8)]
# The SVD UNet's four temporal-attention sites (14 frames, head dim 64).
SVD_BLOCK_SHAPES = [(2, 14, 4096, 320, 5), (2, 14, 1024, 640, 10), (2, 14, 256, 1280, 20),
                    (2, 14, 64, 1280, 20)]


# ---- kernel 3 --------------------------------------------------------------------

@pytest.mark.parametrize("bsz,f,s,cin,cout", TAP_SHAPES + SVD_TAP_SHAPES)
def test_tap_conv_plan_fits_the_card_and_the_kernel(bsz, f, s, cin, cout):
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    plan = tc.launch_plan(bsz, f, s, cin, cout, sms=132)
    bn, stages = plan["bn"], plan["stages"]
    # 320 columns a tile, or 256 where 320-column tiles leave SMs idle
    row_tiles = -(-plan["subs"] // 2)
    assert bn == (320 if row_tiles * -(-cout // 320) >= 132 else 256)
    # ring: A (two 64-row sub-tiles of 64 bf16 columns) and B (bn x 64 bf16)
    # and two mbarriers a stage past a 1024-byte pad; two 64 x NB output tiles
    nb = bn // 2
    assert plan["smem"] == 1024 + stages * (128 * 128 + bn * 128 + 16) + 2 * 64 * nb * 2
    assert 2 <= stages <= tc.MAX_STAGES and plan["smem"] <= SMEM
    # 64-row sub-tiles of each (batch, frame) slab, two to a tile
    assert plan["subs"] == bsz * f * -(-s // 64)
    assert plan["tiles"] == -(-plan["subs"] // 2) * -(-cout // bn)
    assert 1 <= plan["grid"] <= min(132, plan["tiles"])
    assert plan["k_steps"] == 3 * -(-cin // 64)


def test_tap_conv_plan_at_the_unet_sites():
    """320-column tiles at the three large sites; 256 at s = 64, where 68
    tiles of 320 would leave half of the 132 SMs idle."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    widths = [tc.launch_plan(*shape, sms=132)["bn"] for shape in TAP_SHAPES[:4]]
    assert widths == [320, 320, 320, 256]


def test_tap_conv_plan_at_the_svd_sites():
    """At 14 frames the same widths as at 17: 320 columns where the tiles
    fill the card, 256 at s = 64 (56 tiles of 320 or 70 of 256 against 132
    SMs); every
    (batch, frame) slab of 4096 rows is 64 whole sub-tiles."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    plans = [tc.launch_plan(*shape, sms=132) for shape in SVD_TAP_SHAPES]
    assert [p["bn"] for p in plans] == [320, 320, 320, 256]
    assert [p["subs"] for p in plans] == [28 * 64, 28 * 16, 28 * 4, 28]
    assert [p["grid"] for p in plans] == [132, 132, 132, 70]


@pytest.mark.parametrize("cin,cout", [(16, 64), (48, 64), (0, 64), (64, 4), (64, 12)])
def test_tap_conv_plan_refuses_shapes_the_kernel_does_not_take(cin, cout):
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    with pytest.raises(ValueError):
        tc.launch_plan(1, 3, 64, cin, cout)


def test_tap_conv_plan_matches_the_kernel_instantiations():
    """The tile widths the plan may pick are the ones the C entry point
    dispatches on (NB columns x 2 accumulators), its shared-memory
    formula is the source's, and the products are wgmma, not mma.sync."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    text = (cuda_lib.CSRC / "temporal_conv.cu").read_text()
    cases = {int(bn): int(nb) for bn, nb in re.findall(r"case (\d+): return launch<(\d+)>", text)}
    assert set(cases) == set(tc.TILE_WIDTHS)
    assert "constexpr int NACC = 2;" in text
    assert all(bn == 2 * nb for bn, nb in cases.items())
    assert cases == tc._ACC_WIDTH
    assert "return 1024 + stages * (STAGE_BYTES + 16) + 2 * OUT_BYTES;" in text
    assert "wgmma_ss<NB>" in text and "tma_load_4d" in text
    assert "mma_sync" not in text and "wmma" not in text and "mma.sync" not in text


# ---- kernel 5 --------------------------------------------------------------------

@pytest.mark.parametrize("b,f,s,c,heads", BLOCK_SHAPES + SVD_BLOCK_SHAPES)
def test_temporal_block_plan_fits_the_card_and_the_kernel(b, f, s, c, heads):
    from animate_anything_tpu_torch.ops import geglu
    from animate_anything_tpu_torch.ops import temporal_block as tb

    plan = tb.launch_plan(b, f, s, c, heads, sms=132)
    d = c // heads
    L, chunks, stages = plan["L"], plan["chunks"], plan["stages"]
    # a row tile: L locations x f frames, frame-major, at most 128 rows
    assert L == min(128 // f, s) and 1 <= L and L * f <= 128
    assert chunks == -(-d // 64) <= 4
    # ring: the LN tile's step (128 x 64) and three 64 x 64 weight boxes and
    # two mbarriers a stage past a 1024-byte pad; then q, k and every v chunk
    assert plan["smem"] == 1024 + stages * (128 * 128 + 3 * 64 * 128 + 16) + (2 + chunks) * 128 * 128
    assert 2 <= stages <= tb.MAX_STAGES and plan["smem"] <= SMEM
    assert plan["loc_tiles"] == -(-s // L)
    assert plan["items"] == b * plan["loc_tiles"] * heads
    assert 1 <= plan["grid"] <= min(132, plan["items"])
    out = geglu.gemm_plan(b * f * s, c, c)
    assert (plan["bn_out"], plan["stages_out"], plan["grid_out"], plan["smem_out"]) == (
        out["bn"], out["stages"], out["grid"], out["smem"])
    assert plan["smem_out"] <= SMEM and plan["bn_out"] in geglu.OUT_BN


def test_temporal_block_plan_at_the_svd_sites():
    """At 14 frames a row tile holds 9 locations (126 of its 128 rows);
    no SVD site's s is a multiple of 9, so every site ends on a ragged tile
    of s mod 9 locations, which the kernel's edge handles as at 17 frames
    (7 locations a tile there)."""
    from animate_anything_tpu_torch.ops import temporal_block as tb

    for b, f, s, c, heads in SVD_BLOCK_SHAPES:
        plan = tb.launch_plan(b, f, s, c, heads, sms=132)
        assert plan["L"] == 9 and plan["chunks"] == 1
        assert s % 9 and plan["loc_tiles"] == s // 9 + 1
        assert plan["items"] == b * plan["loc_tiles"] * heads
        assert tb.kernel_ok(f, c, heads) and tb.fused_ok(f, c, heads, c // heads)


def test_temporal_block_plan_matches_the_kernel():
    """The plan's limits and shared-memory formula are the source's, and
    the projections are wgmma fed by TMA, with no mma.sync left."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import temporal_block as tb

    text = (cuda_lib.CSRC / "temporal_block.cu").read_text()
    assert "return 1024 + stages * (STAGE_BYTES + 16) + (2 + chunks) * TILE_BYTES;" in text
    assert re.search(r"constexpr int ROWS = (\d+);", text).group(1) == str(tb.TILE_ROWS)
    assert int(re.search(r"constexpr int MAX_CHUNKS = (\d+);", text).group(1)) * 64 == \
        tb.MAX_HEAD_DIM
    assert tb.MAX_FRAMES == tb.TILE_ROWS and f"c > {tb.MAX_C}" in text
    assert "wgmma_ss<192>" in text and "tma_load_3d" in text
    assert "mma_sync" not in text and "mma.sync" not in text and "ldmatrix" not in text


def test_kernel_reach_covers_the_jax_gate_case_by_case():
    """Every (f, c, heads, d) that ``fused_ok`` sends to the fused block
    with d ≤ 256 is one the kernel takes; above d = 256 it takes none."""
    from animate_anything_tpu.ops import temporal_block as jtb
    from animate_anything_tpu_torch.ops import temporal_block as ptb

    admitted = 0
    for f in (1, 2, 4, 17, 32, 33, 48, 64, 100, 128, 129):
        for d in (8, 16, 24, 40, 64, 72, 128, 136, 256, 264, 320):
            for heads in (1, 2, 5, 8, 20):
                c = heads * d
                if d > ptb.MAX_HEAD_DIM:
                    assert not ptb.kernel_ok(f, c, heads), (f, c, heads)
                elif jtb.fused_ok(f, c, heads, d):
                    assert ptb.kernel_ok(f, c, heads), (f, c, heads)
                    admitted += 1
    assert admitted > 200


@pytest.mark.parametrize("f", [33, 48, 64, 128])
@pytest.mark.parametrize("d", [40, 72, 128, 256])
def test_kernel_reach_admits_long_clips_and_odd_head_dims(f, d):
    """f in (32, 128] and d in {40, 72, 128, 256}, which the first kernel
    refused (f ≤ 32, d % 16 == 0, d ≤ 64): the reach admits them, and the
    wrapper goes on to its device check (a meta tensor is no CUDA tensor)."""
    from animate_anything_tpu_torch.ops import temporal_block as tb

    c = 2 * d
    assert tb.kernel_ok(f, c, 2)
    meta = [torch.empty(1, f, 4, c, device="meta", dtype=torch.bfloat16)]
    meta += [torch.empty(c, device="meta") for _ in range(2)]
    meta += [torch.empty(c, c, device="meta", dtype=torch.bfloat16) for _ in range(4)]
    meta += [torch.empty(c, device="meta")]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tb.temporal_block(*meta, heads=2)


@pytest.mark.parametrize("f,d", [(17, 320), (4, 264), (48, 512)])
def test_wrapper_raises_above_the_largest_head_dim(f, d):
    from animate_anything_tpu_torch.ops import temporal_block as tb

    c = 2 * d
    assert not tb.kernel_ok(f, c, 2)
    meta = [torch.empty(1, f, 4, c, device="meta", dtype=torch.bfloat16)]
    meta += [torch.empty(c, device="meta") for _ in range(2)]
    meta += [torch.empty(c, c, device="meta", dtype=torch.bfloat16) for _ in range(4)]
    meta += [torch.empty(c, device="meta")]
    with pytest.raises(ValueError, match="head dim"):
        tb.temporal_block(*meta, heads=2)
    with pytest.raises(ValueError, match="head dim"):
        tb.launch_plan(1, f, 4, c, 2)


# ---- kernel 5's stages against JAX -------------------------------------------------

def _jax_block(x, lns, lnb, wq, wk, wv, wo, bo, heads):
    """JAX's twin on JAX's (in, out) weights."""
    from animate_anything_tpu.ops.temporal_block import _reference_bfsc

    c = x.shape[-1]
    return np.asarray(_reference_bfsc(x, lns.reshape(1, c), lnb.reshape(1, c), wq, wk, wv, wo,
                                      bo.reshape(1, c), heads=heads, d=c // heads))


@pytest.mark.parametrize("s,c", [(12, 64), (9, 80)])
def test_ln_stage_matches_jax_twin(s, c):
    from animate_anything_tpu_torch.ops.temporal_block import ln_stage

    x, lns, lnb, _, _ = _inputs(1, s, c, seed=c)
    eye, zero = np.eye(c, dtype=np.float32), np.zeros((c, c), np.float32)
    want = _jax_block(x, lns, lnb, zero, zero, eye, eye, np.zeros(c, np.float32), 1) - x
    np.testing.assert_allclose(n(ln_stage(t(x), t(lns), t(lnb))), want, atol=1e-5)


@pytest.mark.parametrize("f,s,c,heads", [(17, 12, 128, 2), (48, 5, 80, 2), (4, 9, 64, 8)],
                         ids=["f17-d64", "f48-d40", "f4-d8"])
def test_attention_stage_matches_jax_twin(f, s, c, heads):
    from animate_anything_tpu_torch.ops.temporal_block import attention_stage, ln_stage

    x, lns, lnb, (wq, wk, wv, _), _ = _inputs(f, s, c, seed=f + c)
    eye = np.eye(c, dtype=np.float32)
    want = _jax_block(x, lns, lnb, wq, wk, wv, eye, np.zeros(c, np.float32), heads) - x
    got = attention_stage(ln_stage(t(x), t(lns), t(lnb)), t(wq.T), t(wk.T), t(wv.T),
                          heads=heads)
    np.testing.assert_allclose(n(got), want, atol=1e-5)


@pytest.mark.parametrize("f,s,c,heads", [(17, 12, 128, 2), (48, 5, 80, 2)],
                         ids=["f17-d64", "f48-d40"])
def test_out_stage_completes_the_jax_twin(f, s, c, heads):
    from animate_anything_tpu_torch.ops.temporal_block import attention_stage, ln_stage, \
        out_stage

    x, lns, lnb, (wq, wk, wv, wo), bo = _inputs(f, s, c, seed=2 * f + c)
    o = attention_stage(ln_stage(t(x), t(lns), t(lnb)), t(wq.T), t(wk.T), t(wv.T), heads=heads)
    got = out_stage(o, t(wo.T), t(bo), t(x))
    np.testing.assert_allclose(n(got), _jax_block(x, lns, lnb, wq, wk, wv, wo, bo, heads),
                               atol=1e-5)


def test_reference_matches_bfsc_pallas_kernel_at_48_frames_and_d40():
    """``_build_bfsc`` at f = 48, d = 40 (a head dim the first kernel
    refused) and s = 16 = nblk·p, in interpret mode."""
    from animate_anything_tpu.ops.temporal_block import _bfsc_geometry, _build_bfsc
    from animate_anything_tpu_torch.ops.temporal_block import temporal_block

    f, s, c, heads = 48, 16, 80, 2
    p, _, _, nblk = _bfsc_geometry(f, s, c)
    assert s % (nblk * p) == 0
    x, lns, lnb, ws, bo = _inputs(f, s, c, seed=6)
    with pltpu.force_tpu_interpret_mode():
        want = _build_bfsc(f, s, heads, c // heads, c, 1e-5)(
            x, lns.reshape(1, c), lnb.reshape(1, c), *ws, bo.reshape(1, c))
    got = temporal_block(t(x), t(lns), t(lnb), *[t(w.T) for w in ws], t(bo), heads=heads)
    assert math.isfinite(float(got.abs().max()))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-4)


def test_profiler_attributes_the_shared_passes_to_their_kernel():
    """Kernel 5's LayerNorm pass and out-projection are kernel 2's templates
    instantiated under kernel 5's owner tag, so a profile counts them in
    kernel 5's group, and kernel 2's own instantiations in kernel 2's."""
    from animate_anything_tpu_torch.utils.profiling import kernel_group

    k5, k2 = "temporal_block (kernel 5)", "ln_geglu (kernel 2)"
    assert kernel_group("void aat::gemm::layer_norm_kernel<8, aat::temporal_block>(...)") == k5
    assert kernel_group("void aat::gemm::tma_gemm_kernel<160, false, aat::temporal_block>("
                        "aat::gemm::GemmParams)") == k5
    assert kernel_group("aat::(anonymous namespace)::temporal_block_attention_kernel("
                        "aat::(anonymous namespace)::AttnParams)") == k5
    assert kernel_group("void aat::gemm::tma_gemm_kernel<256, true, aat::ln_geglu_ff>("
                        "aat::gemm::GemmParams)") == k2
    assert kernel_group("void aat::gemm::layer_norm_kernel<32, aat::ln_geglu_ff>(...)") == k2
    assert kernel_group("void aat::(anonymous namespace)::tap_conv_kernel<160, 2>("
                        "aat::(anonymous namespace)::TapParams)") == "tap_conv (kernel 3)"
