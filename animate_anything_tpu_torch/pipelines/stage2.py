"""Stage-2 transparent (RGBA) video pipelines — the port of
``animate_anything_tpu/pipelines/stage2.py``.

The denoise loop is ``LatentToVideoPipeline``'s; every decoded frame and its
latent then go through the transparent decoder (``UNet384``) to RGBA, alpha
binarised at 127 and the colour rescaled to 0..255. The Concat variant feeds
a 9-channel UNet built with ``condition_mode="channel_concat"``, which
concatenates the condition latents on the channel axis itself, so its loop
is the same.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from animate_anything_tpu_torch.models.transparent_vae import UNet384, decode_rgba_video
from animate_anything_tpu_torch.pipelines.latent2video import LatentToVideoPipeline
from animate_anything_tpu_torch.utils.media import save_gif


class MaskedLatentToVideoPipeline(LatentToVideoPipeline):
    """5-channel (mask) model → RGB video + per-frame RGBA decode."""

    def __init__(self, *args, unet384: Optional[UNet384] = None, **kw):
        super().__init__(*args, **kw)
        self.unet384 = unet384

    @torch.no_grad()
    def __call__(self, *args, decode_rgba: bool = True, **kw):
        """→ (video, latents, rgba): the base pipeline's outputs and the
        (b, f, h, w, 4) RGBA on a 0..255 scale, or None without a decoder or
        with ``decode_rgba=False``."""
        video, latents = super().__call__(*args, **kw)
        if not decode_rgba or self.unet384 is None:
            return video, latents, None
        return video, latents, decode_rgba_video(self.unet384, video,
                                                 latents / self.vae.config.scaling_factor)


class ConcatLatentToVideoPipeline(MaskedLatentToVideoPipeline):
    """9-channel variant: the condition latents concatenated on the channel
    axis each step, by a UNet built with ``condition_mode="channel_concat"``."""


def save_rgba_outputs(out_dir: str, rgba: np.ndarray, fps: int = 8) -> dict:
    """Write ``decoded.gif`` (the colour), ``decoded_rgba.webp`` and
    ``decoded_alpha.webp`` of the first video of ``rgba`` (b, f, h, w, 4) on a
    0..255 scale; → {"gif", "rgba", "alpha"} paths."""
    os.makedirs(out_dir, exist_ok=True)
    rgba8 = np.clip(np.asarray(rgba[0]), 0, 255).astype(np.uint8)
    paths = {"gif": save_gif(os.path.join(out_dir, "decoded.gif"), rgba8[..., :3], fps=fps)}
    for key, frames in (("rgba", [Image.fromarray(fr, "RGBA") for fr in rgba8]),
                        ("alpha", [Image.fromarray(fr[..., 3], "L") for fr in rgba8])):
        paths[key] = os.path.join(out_dir, f"decoded_{key}.webp")
        frames[0].save(paths[key], save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
    return paths
