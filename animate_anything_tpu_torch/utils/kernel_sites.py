"""The sites of kernels 8 and 4 in one CFG forward of the full-width UNet
in the opt-in configuration (n = 34 = 2 × 17 frames at 64×64 latents), with
their launch counts. ``chip_smoke.py`` checks and times both kernels at
these sites and sums them over a forward by the counts; the plan tests
hold the launch plans to them.
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
