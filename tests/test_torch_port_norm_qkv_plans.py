"""Launch plans of kernel 7 (the one-pass GroupNorm, ``ops/streaming_group_norm
.launch_plan``) and kernel 11 (LayerNorm → q‖k‖v, ``ops/ln_qkv_attention
.launch_plan``), without a card: co-residency, shared memory, TMA boxes and
the coverage of rows and tiles, at the VAE's and the UNet's sites and at
JAX's test shapes. The kernels themselves run only on the card
(``chip_smoke.py``)."""

import collections

import pytest
import torch

from animate_anything_tpu_torch.ops import ln_qkv_attention as lq
from animate_anything_tpu_torch.ops import streaming_group_norm as sg
from animate_anything_tpu_torch.utils.kernel_sites import (LN_QKV_SITES, STREAM_GN_DECODE_SITES,
                                                           STREAM_GN_ENCODE_SITES)

SM_SHARED = 233472          # shared memory of an H100 SM
BLOCK_SHARED = 232448       # the most a block may have
SM_THREADS, SM_REGISTERS = 2048, 65536
GN_REGISTERS = 128          # __launch_bounds__(256, 2)

# JAX's test shapes (tests/test_torch_port_group_norm.py) and the VAE's sites
GN_TEST_SHAPES = ((3, 48, 128), (2, 16, 128), (2, 96, 128), (2, 16, 256))
GN_SITES = sorted({(n, s, c) for n, s, c, _, _ in STREAM_GN_ENCODE_SITES + STREAM_GN_DECODE_SITES}
                  | set(GN_TEST_SHAPES))


@pytest.mark.parametrize("n,s,c", GN_SITES)
def test_group_norm_plan_fits_and_is_resident(n, s, c):
    """Two blocks a SM fit its shared memory, threads and registers, so the
    cooperative launch of the whole grid is resident; a block's pieces and
    its reduction buffers fit what a block may have."""
    plan = sg.launch_plan(n, s, c, 32)
    small = n * s * c * 2 <= sg.SMALL_BYTES
    assert plan["grid"] == (1 if small else sg.BLOCKS_PER_SM) * 132
    assert sg.BLOCKS_PER_SM * (plan["smem"] + 256 + 1024) <= SM_SHARED
    assert plan["smem"] <= BLOCK_SHARED
    assert sg.BLOCKS_PER_SM * plan["threads"] <= SM_THREADS
    assert sg.BLOCKS_PER_SM * plan["threads"] * GN_REGISTERS <= SM_REGISTERS
    assert 2 <= plan["pieces"] <= sg.MAX_PIECES and 1 <= plan["ring"] < plan["pieces"]
    assert plan["piece_rows"] * 2 * c <= sg.COPY_BYTES
    assert plan["ct"] * plan["rt"] <= plan["threads"] and plan["ct"] * 8 == c


def _rows_read(plan, n, s):
    """Each block's rows as the kernel walks them in the sums (held pieces,
    then the ring's chunks): (block, row) pairs, and the rows read twice."""
    rows, twice = [], 0
    total, grid, prow = n * s, plan["grid"], plan["piece_rows"]
    r_block = -(-total // grid)
    for b in range(grid):
        r0, r1 = min(total, b * r_block), min(total, (b + 1) * r_block)
        fits = r1 - r0 <= plan["pieces"] * prow
        held = r1 - r0 if fits else (plan["pieces"] - plan["ring"]) * prow
        rows.extend(range(r0, r1))
        twice += max(0, r1 - r0 - held)
    return rows, twice


@pytest.mark.parametrize("n,s,c", GN_SITES)
def test_group_norm_plan_covers_every_row_once(n, s, c):
    """The blocks' ranges tile the n·s rows: every row of every sample once,
    in order; the rows read twice are exactly those past the held pieces."""
    plan = sg.launch_plan(n, s, c, 32)
    rows, twice = _rows_read(plan, n, s)
    assert rows == list(range(n * s))
    assert plan["read_once"] == (twice == 0) and plan["rows_read_twice"] == twice
    held = n * s - twice
    assert held / (n * s) >= min(1.0, plan["held_fraction"]) - 1.0 / plan["rows_block"] - 1e-9


def test_group_norm_sites_that_read_x_once():
    """x is read once where a block's range fits its pieces: the image
    encode's levels up to 256² x 128, none of the 16-frame decode's."""
    once = set()
    for n, s, c, _, _ in STREAM_GN_ENCODE_SITES + STREAM_GN_DECODE_SITES:
        if sg.launch_plan(n, s, c, 32)["read_once"]:
            once.add((n, s, c))
    assert once == {(1, 65536, 128), (1, 16384, 256), (1, 16384, 512), (1, 4096, 512)}


def test_group_norm_plan_refuses_what_the_kernel_does_not_take():
    for n, s, c, groups in ((1, 64, 12, 4), (1, 64, 4096, 32), (1, 64, 128, 3), (0, 64, 128, 32)):
        with pytest.raises(ValueError):
            sg.launch_plan(n, s, c, groups)


def test_vae_sites_are_the_opt_in_encode_and_decode():
    """A 512 px image encode and a 16-frame decode of the full-width VAE on
    the meta device under the opt-in norm switch call kernel 7 at exactly the
    listed sites (22 and 30 calls): the wrapper takes its kernel path with
    the launches recorded and not made."""
    from animate_anything_tpu_torch.models.vae import (AutoencoderKL, VAEConfig, decode_video,
                                                       encode_video)
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops.spatial_conv import opt_in_config

    calls = collections.Counter()
    launch = sg._launch

    def record(x2, scale, bias, groups, eps, silu):
        calls[(*x2.shape, silu)] += 1
        return launch(x2, scale, bias, groups, eps, silu)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_lib, "call", lambda name, *args: None)
        mp.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
        mp.setattr(cuda_lib, "sm_count", lambda device: 132)
        mp.setattr(sg, "tickets", lambda device, count: torch.zeros(count, device=device))
        mp.setattr(sg, "_launch", record)
        with torch.device("meta"):
            vae = AutoencoderKL(VAEConfig()).to(torch.bfloat16)
            pixels = torch.empty(1, 1, 512, 512, 3, dtype=torch.bfloat16)
            latents = torch.empty(1, 16, 64, 64, 4, dtype=torch.bfloat16)
        with torch.no_grad(), opt_in_config():
            assert encode_video(vae, pixels).shape == (1, 1, 64, 64, 4)
            encode = dict(calls)
            calls.clear()
            assert decode_video(vae, latents).shape == (1, 16, 512, 512, 3)
    assert encode == {(n, s, c, silu): k for n, s, c, silu, k in STREAM_GN_ENCODE_SITES}
    assert calls == {(n, s, c, silu): k for n, s, c, silu, k in STREAM_GN_DECODE_SITES}
    assert sum(encode.values()) == 22 and sum(calls.values()) == 30


# ---- kernel 11 ----------------------------------------------------------------

QKV_SHAPES = [(b * s, c, 64 * h) for b, s, c, h in LN_QKV_SITES] + [(2 * 256, 128, 128),
                                                                    (1 * 300, 192, 192)]


def _tiles(plan, n, hd):
    """The GEMM's tiles as the kernel walks them (column tile fastest): the
    (output, first row, first column) each covers."""
    per_w = hd // plan["bn"]
    out = []
    for tile in range(plan["tiles"]):
        row_tile, ct = divmod(tile, 3 * per_w)
        which, col0 = divmod(ct, per_w)
        out.append((which, row_tile * lq.GEMM_BM, col0 * plan["bn"]))
    return out


@pytest.mark.parametrize("n,c,hd", QKV_SHAPES)
def test_ln_qkv_plan_covers_q_k_v_once(n, c, hd):
    """The tiles cover every (row, column) of q, k and v once; no tile
    straddles two of them (its width divides heads·head_dim), so only the q
    tiles take the log2 e/√d scale, whole."""
    plan = lq.launch_plan(n, c, hd)
    bn = plan["bn"]
    assert hd % bn == 0 and bn % 64 == 0 and bn in lq.TILE_WIDTHS
    seen = collections.Counter()
    for which, r0, c0 in _tiles(plan, n, hd):
        assert c0 + bn <= hd  # inside one of q, k, v
        seen[(which, r0, c0)] += 1
    assert len(seen) == plan["tiles"] and max(seen.values()) == 1
    row_tiles = -(-n // lq.GEMM_BM)
    for which in range(3):
        cols = sorted(c0 for w, r0, c0 in seen if w == which and r0 == 0)
        assert cols == list(range(0, hd, bn))
        assert {r0 for w, r0, _ in seen if w == which} == {lq.GEMM_BM * t for t in range(row_tiles)}
    scaled = [t for t in _tiles(plan, n, hd) if t[0] == 0]
    assert len(scaled) == plan["tiles"] // 3


@pytest.mark.parametrize("n,c,hd", QKV_SHAPES)
def test_ln_qkv_plan_fits_shared_memory_and_tma_boxes(n, c, hd):
    """The ring (x tile 128 x 64, weight tile 64 x bn as 64-column TMA boxes
    of 128-byte rows), four 64 x 64 output chunks and the LayerNorm vectors
    fit a block; boxes stay within TMA's 256 elements a dimension; the grid
    is persistent, one block a SM; the accumulator (bn/2 fp32 a thread)
    leaves room in the 255 registers of a 256-thread block."""
    plan = lq.launch_plan(n, c, hd)
    bn = plan["bn"]
    assert 2 <= plan["stages"] <= lq.MAX_STAGES
    assert plan["smem"] <= BLOCK_SHARED
    assert plan["smem"] == lq._smem(bn, plan["stages"], c)
    if plan["stages"] < lq.MAX_STAGES:
        assert lq._smem(bn, plan["stages"] + 1, c) > lq.SMEM_LIMIT
    for box in ((64, lq.GEMM_BM), (64, lq.GEMM_BK), (64, 64)):
        assert all(1 <= d <= 256 for d in box) and box[0] * 2 == 128
    assert plan["grid"] == min(plan["tiles"], 132)
    assert bn // 2 + 32 < 255


def test_ln_qkv_plan_at_the_unet_sites():
    """The widths the sites take: 320 at the first two levels (hd = 320,
    640), 256 at hd = 1280, where 320 would leave a seventh wave mostly
    idle."""
    widths = [lq.launch_plan(b * s, c, 64 * h)["bn"] for b, s, c, h in LN_QKV_SITES]
    assert widths == [320, 320, 256]


def test_ln_qkv_plan_refuses_what_the_kernel_does_not_take():
    for n, c, hd in ((64, 12, 128), (64, 128, 96), (0, 128, 128), (64, 8192, 128)):
        with pytest.raises(ValueError):
            lq.launch_plan(n, c, hd)


def test_profiler_attributes_kernel_11s_passes_to_it():
    """Kernel 11's statistics pass is kernel 2's LayerNorm template with the
    statistics alone under kernel 11's owner tag, so a profile counts it, and
    the GEMM, in kernel 11's group, and kernel 2's own instantiation in
    kernel 2's."""
    from animate_anything_tpu_torch.utils.profiling import kernel_group

    k11 = "ln_qkv (kernel 11)"
    assert kernel_group("void aat::gemm::layer_norm_kernel<8, 8, aat::ln_qkv, true>("
                        "const __nv_bfloat16*, const float*, const float*, void*, int, int, "
                        "int, float)") == k11
    assert kernel_group("void aat::lnqkv::ln_qkv_gemm_kernel<320>("
                        "aat::lnqkv::Params)") == k11
    assert kernel_group("void aat::gemm::layer_norm_kernel<8, 8, aat::ln_geglu_ff, false>("
                        "...)") == "ln_geglu (kernel 2)"
