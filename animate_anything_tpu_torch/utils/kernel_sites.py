"""The sites of kernels 8, 4 and 6 in one CFG forward of the full-width
UNet in the opt-in configuration (n = 34 = 2 × 17 frames at 64×64 latents),
of kernel 7 in the SD VAE's 512 px image encode and 16-frame decode, of
kernels 1, 2, 3 and 5 in one CFG forward of the full-width SVD UNet under
``attn_impl="pallas"``, and of kernels 1-5 in one CFG forward of the
full-width UNet at the stage-2 request's shapes (384 px, 8 frames), with
their launch counts. ``chip_smoke.py`` checks
and times the kernels at these sites and sums them by the counts; the plan
tests hold the launch plans to them.
"""

from __future__ import annotations

# Kernel 8: (H = W, cin, cout, time bias, residual, launches a CFG forward).
# Stage 1 of a ResnetBlock2D (GroupNorm -> SiLU -> conv1 + time bias) takes
# the block's input width, stage 2 (-> conv2 + shortcut) its output width:
# 4 + 4 + 4 + 2 down, 2 mid and 3 x 4 up resnets, 44 stages a forward.
SPATIAL_CONV_SITES = (
    (64, 320, 320, True, False, 2), (64, 960, 320, True, False, 1),
    (64, 640, 320, True, False, 2), (64, 320, 320, False, True, 5),
    (32, 320, 640, True, False, 1), (32, 640, 640, True, False, 1),
    (32, 1920, 640, True, False, 1), (32, 1280, 640, True, False, 1),
    (32, 960, 640, True, False, 1), (32, 640, 640, False, True, 5),
    (16, 640, 1280, True, False, 1), (16, 1280, 1280, True, False, 1),
    (16, 2560, 1280, True, False, 2), (16, 1920, 1280, True, False, 1),
    (16, 1280, 1280, False, True, 5),
    (8, 1280, 1280, True, False, 4), (8, 2560, 1280, True, False, 3),
    (8, 1280, 1280, False, True, 7),
)
# Kernel 4: (s, k, c, launches a CFG forward): transformer_in (512 -> 320),
# then the proj_out of the spatial and temporal transformers at each level;
# 33 a forward.
PROJ_SITES = ((4096, 512, 320, 1), (4096, 320, 320, 10), (1024, 640, 640, 10),
              (256, 1280, 1280, 10), (64, 1280, 1280, 2))
# Kernel 6: (n, s, c, launches a CFG forward), the GroupNorm statistics that
# no producer kernel hands over: the temporal convs' first stages (n = 2
# samples of 17 frames x h·w rows) and the resnet and transformer norms of
# 34 frames; 67 a forward, the profile's kernel-6 count.
# tests/test_torch_port_sums_plans.py counts them through the wrapper over
# one forward of the full-width UNet on the meta device.
CHANNEL_SUMS_SITES = (
    (2, 69632, 320, 6), (2, 17408, 640, 5), (2, 4352, 1280, 5), (2, 1088, 1280, 7),
    (34, 4096, 320, 7), (34, 4096, 960, 1), (34, 4096, 640, 2),
    (34, 1024, 320, 1), (34, 1024, 640, 6), (34, 1024, 1920, 1), (34, 1024, 1280, 1),
    (34, 1024, 960, 1),
    (34, 256, 640, 1), (34, 256, 1280, 6), (34, 256, 2560, 2), (34, 256, 1920, 1),
    (34, 64, 1280, 11), (34, 64, 2560, 3),
)

# Kernel 7: (n, s, c, SiLU, launches) in the opt-in configuration: every
# GroupNorm of the VAE (the resnets' two, with SiLU; the mid-block
# attention's, without; the output norm, with) at its level's h·w rows and
# width. The image encode (n = 1 image at 512 px) runs 22, the 16-frame
# decode (n = 16 at 64² latents) 30: 52 a request.
# tests/test_torch_port_norm_qkv_plans.py counts them through the wrapper
# over an encode and a decode of the full-width VAE on the meta device.
STREAM_GN_ENCODE_SITES = (
    (1, 262144, 128, True, 4), (1, 65536, 128, True, 1), (1, 65536, 256, True, 3),
    (1, 16384, 256, True, 1), (1, 16384, 512, True, 3), (1, 4096, 512, True, 9),
    (1, 4096, 512, False, 1),
)
STREAM_GN_DECODE_SITES = (
    (16, 4096, 512, True, 10), (16, 4096, 512, False, 1), (16, 16384, 512, True, 6),
    (16, 65536, 512, True, 1), (16, 65536, 256, True, 5), (16, 262144, 256, True, 1),
    (16, 262144, 128, True, 6),
)
# Kernel 11's sites, as kernel 1's (FLASH_SITES in chip_smoke.py): the UNet's
# spatial self-attention levels, (b, s, c, heads) of a CFG forward's 34
# frames; no model path of the JAX package or the port calls kernel 11.
LN_QKV_SITES = ((34, 4096, 320, 5), (34, 1024, 640, 10), (34, 256, 1280, 20))

# The SVD UNet (``models/svd_unet.py``), one CFG forward under "pallas":
# b = 2, 14 frames at 64×64 latents, so b·f = 28; head dim 64 everywhere.
# Transformers: 5 at each of the levels s = 4096 / 1024 / 256 (two down,
# three up) and 1 in the mid block (s = 64); resnets: 5 at each of those
# three levels and 7 at s = 64 (two down, two mid, three up).
SVD_BF = 28
SVD_FRAMES = 14
# Kernel 1: (s, heads, calls): the spatial self-attention where s ≥ 128
# (the mid block's s = 64 runs the plain path, as in JAX); 15 a forward.
SVD_FLASH_SITES = ((4096, 5, 5), (1024, 10, 5), (256, 20, 5))
# Kernel 2: (n rows, c, calls): the spatial block's tail and the temporal
# block's ff_in and ff, 3 a transformer; 48 a forward.
SVD_GEGLU_SITES = ((SVD_BF * 4096, 320, 15), (SVD_BF * 1024, 640, 15),
                   (SVD_BF * 256, 1280, 15), (SVD_BF * 64, 1280, 3))
# Kernel 3: (s, c, calls) at (b, f) = (2, 14), stage 1 and stage 2 (with
# the residual) of every temporal resnet, GroupNorm eps 1e-6; 44 a forward.
SVD_TAP_SITES = ((4096, 320, 10), (1024, 640, 10), (256, 1280, 10), (64, 1280, 14))
# Kernel 5: (s, c, heads, calls) at (b, f) = (2, 14), the temporal block's
# norm1 + attn1; 16 a forward.
SVD_BLOCK_SITES = ((4096, 320, 5, 5), (1024, 640, 10, 5), (256, 1280, 20, 5),
                   (64, 1280, 20, 1))

# The stage-2 request (``cli_stage2.main_eval`` at
# ``configs/layerdiffuse_stage2_384.yaml`` with attn_impl=pallas): the
# full-width mask+motion UNet, one CFG forward of b = 2 at 48×48 latents,
# 8 frames + the condition frame, so f = 9 and b·f = 18; s = 2304, 576, 144
# and 36 (the last three end on ragged tiles). The same modules as at
# 64×64 latents, so the same counts a forward: kernel 1 15, kernel 2 33,
# kernel 3 88, kernel 4 33, kernel 5 34.
# tests/test_torch_port_stage2_sites.py counts them through the wrappers
# over that forward on the meta device (and the Concat UNet's: f = 8).
STAGE2_BF = 18
STAGE2_FRAMES = 9
# Kernel 1: (s, heads, calls); the mid block's s = 36 runs the plain path.
STAGE2_FLASH_SITES = ((2304, 5, 5), (576, 10, 5), (144, 20, 5))
# Kernel 2: (n rows, c, calls): the spatial transformers' tails and
# transformer_in's (c = 512).
STAGE2_GEGLU_SITES = ((STAGE2_BF * 2304, 512, 1), (STAGE2_BF * 2304, 320, 10),
                      (STAGE2_BF * 576, 640, 10), (STAGE2_BF * 144, 1280, 10),
                      (STAGE2_BF * 36, 1280, 2))
# Kernel 3: (s, c, calls) at (b, f) = (2, 9), the four stages of every
# temporal conv layer, a quarter of them (the last) with the residual.
STAGE2_TAP_SITES = ((2304, 320, 20), (576, 640, 20), (144, 1280, 20), (36, 1280, 28))
# Kernel 4: (s, k, c, calls) at n = b·f = 18.
STAGE2_PROJ_SITES = ((2304, 512, 320, 1), (2304, 320, 320, 10), (576, 640, 640, 10),
                     (144, 1280, 1280, 10), (36, 1280, 1280, 2))
# Kernel 5: (s, c, heads, calls) at (b, f) = (2, 9): transformer_in (8
# heads of 64 over 512) and the temporal transformers.
STAGE2_BLOCK_SITES = ((2304, 512, 8, 2), (2304, 320, 5, 10), (576, 640, 10, 10),
                      (144, 1280, 20, 10), (36, 1280, 20, 2))
