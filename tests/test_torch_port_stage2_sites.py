"""The kernel sites of one CFG forward of the full-width mask+motion UNet at
the stage-2 request's shapes (``configs/layerdiffuse_stage2_384.yaml``:
384 px, so 48×48 latents; 8 frames; ``attn_impl="pallas"``), counted by
running that forward on the meta device through the kernels' wrappers
with the launches recorded instead of made (as
``test_torch_port_svd_sites.py`` counts the SVD UNet's): the Masked
pipeline's 5-channel UNet (frame concat, f = 9) at exactly
``utils/kernel_sites.py``'s ``STAGE2_*_SITES``, and the Concat pipeline's
9-channel one (``condition_mode="channel_concat"``, f = 8) at the same
sites with 8 frames.
"""

import collections

import pytest
import torch

from test_torch_port_helpers import one_thread  # noqa: F401 (autouse fixture)

from animate_anything_tpu_torch.utils.kernel_sites import (STAGE2_BF, STAGE2_BLOCK_SITES,
                                                           STAGE2_FLASH_SITES, STAGE2_FRAMES,
                                                           STAGE2_GEGLU_SITES, STAGE2_PROJ_SITES,
                                                           STAGE2_TAP_SITES)


def _meta_forward(condition_mode: str):
    """→ (output shape, {kernel: Counter of recorded shapes})."""
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.ops import (cuda_lib, flash_attention, geglu, proj_residual,
                                                temporal_block, temporal_conv)

    shapes = collections.defaultdict(collections.Counter)

    def recorder(kernel, fn, key):
        def record(*args, **kw):
            shapes[kernel][key(*args)] += 1
            return fn(*args, **kw)
        return record

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_lib, "call", lambda name, *args: None)
        mp.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
        mp.setattr(cuda_lib, "sm_count", lambda device: 132)
        mp.setattr(flash_attention, "flash_forward_with_lse", recorder(
            "flash", flash_attention.flash_forward_with_lse, lambda q, k, v, *a: tuple(q.shape)))
        mp.setattr(geglu, "_launch", recorder("geglu", geglu._launch,
                                              lambda x2, *a: tuple(x2.shape)))
        mp.setattr(temporal_conv, "_launch", recorder(
            "tap_conv", temporal_conv._launch,
            lambda x, a, b, w, bias, res: (tuple(x.shape), w.shape[0], res is not None)))
        mp.setattr(temporal_block, "_launch", recorder(
            "temporal_block", temporal_block._launch, lambda x, *a: (tuple(x.shape), a[-2])))
        mp.setattr(proj_residual, "_launch", recorder(
            "proj", proj_residual._launch, lambda h, w, bias, r: (tuple(h.shape), w.shape[0])))
        with torch.device("meta"):
            unet = UNet3DConditionModel(UNet3DConfig(
                motion_mask=True, motion_strength=True, attn_impl="pallas",
                condition_mode=condition_mode)).to(torch.bfloat16)
            args = (torch.empty(2, 8, 48, 48, 4), 500, torch.empty(2, 77, 1024),
                    torch.empty(2, 1, 48, 48, 4), torch.empty(2, 1, 48, 48, 1), torch.empty(2))
        with torch.no_grad():
            out = unet(*args)
    return tuple(out.shape), shapes


@pytest.mark.parametrize("condition_mode", ["frame_concat", "channel_concat"])
def test_stage2_forward_runs_kernels_1_to_5_at_their_sites(condition_mode):
    shape, shapes = _meta_forward(condition_mode)
    f = STAGE2_FRAMES if condition_mode == "frame_concat" else STAGE2_FRAMES - 1
    bf = 2 * f
    assert shape == (2, 8, 48, 48, 4)
    assert bf == STAGE2_BF or condition_mode == "channel_concat"
    assert shapes["flash"] == {(bf, s, h, 64): k for s, h, k in STAGE2_FLASH_SITES}
    assert shapes["geglu"] == {(n // STAGE2_BF * bf, c): k for n, c, k in STAGE2_GEGLU_SITES}
    assert shapes["tap_conv"] == {((2, f, s, c), c, res): k // 4 * (1 if res else 3)
                                  for s, c, k in STAGE2_TAP_SITES for res in (False, True)}
    assert shapes["temporal_block"] == {((2, f, s, c), h): k
                                        for s, c, h, k in STAGE2_BLOCK_SITES}
    assert shapes["proj"] == {((bf, s, k), c): n for s, k, c, n in STAGE2_PROJ_SITES}
    assert {k: sum(v.values()) for k, v in shapes.items()} == {
        "flash": 15, "geglu": 33, "tap_conv": 88, "temporal_block": 34, "proj": 33}
