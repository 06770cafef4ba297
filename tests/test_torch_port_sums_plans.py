"""Kernel 6's launch plan (``ops/group_norm.py::sums_plan``) and its sites,
on the CPU.

The wrapper picks the column threads, row lanes, slabs and row chunks of
the one-launch channel sums without the card; these tests hold that plan to
what ``csrc/group_norm.cu`` takes (at most 320 threads a block, one wave of
two blocks a SM), check that its blocks cover every (sample, row, channel)
exactly once with no idle column lane, and count the kernel's sites in one
opt-in CFG forward of the full-width UNet (``utils/kernel_sites.
CHANNEL_SUMS_SITES``) by running that forward on the meta device, where
nothing is computed or allocated, through the kernels' wrappers with the
launches recorded instead of made.
"""

import collections
import math
import re

import pytest
import torch

from animate_anything_tpu_torch.utils.kernel_sites import CHANNEL_SUMS_SITES

# (n, s, c): the opt-in forward's sites, the VAE decoder's GroupNorms at 16
# frames (kernel 7's sum pass), the add-with-sums seams (kernel 10) and
# small and odd widths.
SHAPES = ([(n, s, c) for n, s, c, _ in CHANNEL_SUMS_SITES]
          + [(16, 4096, 512), (16, 16384, 512), (16, 65536, 256), (16, 262144, 128),
             (3, 32, 128), (2, 16, 64), (1, 1, 8), (5, 77, 24), (34, 64, 2056)])


@pytest.mark.parametrize("n,s,c", SHAPES)
def test_plan_covers_every_sample_row_and_channel_once(n, s, c):
    from animate_anything_tpu_torch.ops import group_norm as gn

    p = gn.sums_plan(n, s, c, sms=132)
    ct, rt, slabs, chunks, rows = p["ct"], p["rt"], p["slabs"], p["chunks"], p["rows"]
    # column threads cover the c/8 vectors of a row, slab after slab, with no
    # idle lane; every thread of a block is one (column, row lane)
    assert slabs * ct * 8 == c and p["threads"] == ct * rt <= gn.SUMS_THREADS
    # the chunks cover the s rows: chunk k holds [k·rows, (k + 1)·rows) ∩ [0, s)
    assert rows % rt == 0 and (chunks - 1) * rows < s <= chunks * rows
    # the finish of a (sample, slab) reads at most the bytes one block sums
    assert chunks <= max(1, math.isqrt(s) // 2)
    assert p["blocks"] == n * slabs * chunks


@pytest.mark.parametrize("c", [320, 640, 1280])
def test_no_idle_column_lanes_at_the_unet_widths(c):
    """All 40, 80 or 160 vectors of a row are a block's column threads, or
    whole slabs of them; every row lane has every column."""
    from animate_anything_tpu_torch.ops import group_norm as gn

    for n, s in ((34, 4096), (2, 17 * 4096), (34, 64)):
        p = gn.sums_plan(n, s, c)
        assert (c // 8) % p["ct"] == 0 and p["threads"] % p["ct"] == 0
        assert gn.MIN_COLS <= p["ct"] <= gn.MAX_COLS


@pytest.mark.parametrize("n,s,c", [(n, s, c) for n, s, c, _ in CHANNEL_SUMS_SITES])
def test_plan_runs_in_one_wave_at_the_opt_in_sites(n, s, c):
    """Every site's blocks fit one wave of two blocks a SM (a second,
    part-full wave would leave most of the card idle) and fill at least
    half of it."""
    from animate_anything_tpu_torch.ops import group_norm as gn

    p = gn.sums_plan(n, s, c, sms=132)
    assert 132 <= p["blocks"] <= gn.BLOCKS_PER_SM * 132


def test_plan_matches_the_kernel():
    """The plan's limits are the source's, and kernel 6 is one launch: the
    finish is the last block's, after a ticket, with no second pass."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import group_norm as gn

    text = (cuda_lib.CSRC / "group_norm.cu").read_text()
    assert re.search(r"constexpr int MAX_THREADS = (\d+);", text).group(1) == \
        str(gn.SUMS_THREADS)
    assert re.search(r"constexpr int SUMS_BLOCKS_PER_SM = (\d+);", text).group(1) == \
        str(gn.BLOCKS_PER_SM)
    host = text[text.index("int channel_sums("):text.index("}  // namespace\n}  // namespace aat")]
    assert host.count("<<<") == 2 and "channel_sums_kernel<true>" in host
    assert "atomicAdd(tickets" in text and "__threadfence()" in text
    assert "channel_finish" not in text and "channel_partial" not in text


def test_kernel_sites_are_the_opt_in_forwards():
    """One opt-in CFG forward of the full-width UNet (2 × 16 frames at 64×64
    latents, as ``utils/profiling.py`` runs it) on the meta device calls
    kernel 6 at exactly ``CHANNEL_SUMS_SITES``: the wrappers take their
    kernel paths (the tensors are not on the CPU) with the launches recorded
    and not made."""
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import group_norm as gn
    from animate_anything_tpu_torch.ops.spatial_conv import opt_in_config

    shapes = collections.Counter()
    launch = gn._launch_channel_sums

    def record(x2):
        shapes[tuple(x2.shape)] += 1
        return launch(x2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_lib, "call", lambda name, *args: None)
        mp.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
        mp.setattr(cuda_lib, "sm_count", lambda device: 132)
        mp.setattr(gn, "tickets", lambda device, count: torch.zeros(count, device=device))
        mp.setattr(gn, "_launch_channel_sums", record)
        with torch.device("meta"):
            unet = UNet3DConditionModel(UNet3DConfig(motion_mask=True, motion_strength=True,
                                                         attn_impl="pallas"))
            unet = unet.to(torch.bfloat16)
            args = (torch.empty(2, 16, 64, 64, 4), 500, torch.empty(2, 77, 1024),
                    torch.empty(2, 1, 64, 64, 4, dtype=torch.bfloat16),
                    torch.empty(2, 1, 64, 64, 1), torch.empty(2))
        with torch.no_grad(), opt_in_config():
            out = unet(*args)
    assert out.shape == (2, 16, 64, 64, 4)
    assert shapes == {(n, s, c): k for n, s, c, k in CHANNEL_SUMS_SITES}
    assert sum(shapes.values()) == 67
