"""Long-video generation by autoregressive chunking — the port of
``animate_anything_tpu/pipelines/long_video.py``.

On top of ``LatentToVideoPipeline``:

- chunk 0: the usual masked animation from the image latent;
- chunk k: its first ``overlap`` latents (``chunk_frames // 3`` by default)
  are the previous chunk's tail re-noised at the grid's first timestep, and
  the condition latent becomes the last generated frame, so content flows
  across chunk boundaries;
- the chunks' latents are joined (each later chunk without its overlap),
  cut to ``total_frames`` and decoded once.

Every chunk has the same shapes, so it runs the same kernels as a request.
The draws come from an explicit ``torch.Generator``: per chunk the start
latents' noise, then (from chunk 1 on) the tail's; ``noise`` and
``tail_noise`` (lists, one tensor a chunk) override them, so a caller can
feed in another source's draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from animate_anything_tpu_torch.diffusion.schedule import add_noise
from animate_anything_tpu_torch.models.layers import resize_nearest
from animate_anything_tpu_torch.models.vae import decode_video, encode_video


@torch.no_grad()
def generate_long_video(pipe, image: np.ndarray, prompt: str, total_frames: int,
                        chunk_frames: int = 16, overlap: Optional[int] = None,
                        mask_img: Optional[np.ndarray] = None,
                        motion_strength: Optional[float] = None, num_inference_steps: int = 25,
                        guidance_scale: float = 9.0, t_start_fraction: float = 0.0,
                        generator: Optional[torch.Generator] = None, decode: bool = True,
                        noise: Optional[Sequence[torch.Tensor]] = None,
                        tail_noise: Optional[Sequence[torch.Tensor]] = None):
    """→ (video (1, total_frames, H, W, 3) in [-1, 1] or None, latents).
    image (h, w, 3) uint8; mask_img (h, w) uint8, 255 = may move;
    ``noise[k]`` chunk k's start-latent noise (1, chunk_frames, h/8, w/8, 4),
    ``tail_noise[k - 1]`` its re-noised tail's (1, overlap, h/8, w/8, 4)."""
    overlap = overlap if overlap is not None else chunk_frames // 3
    dev = pipe.device
    pixels = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=dev)
    cond_latent = encode_video(pipe.vae, (pixels / 127.5 - 1.0)[None, None])
    h8, w8 = cond_latent.shape[2], cond_latent.shape[3]

    mask = None
    if mask_img is not None:
        m = torch.as_tensor(np.asarray(mask_img, np.float32) / 255.0, device=dev)
        m = resize_nearest(m[None, :, :, None], (h8, w8))[0, :, :, 0]
        mask = (m >= 0.5).float()[None, None, :, :, None]
    prompt_embeds, neg_embeds = pipe.encode_prompt(prompt)
    ts = pipe.get_timesteps(num_inference_steps, t_start_fraction)
    motion = None if motion_strength is None else torch.tensor(
        [motion_strength], dtype=torch.float32, device=dev)

    chunks: list = []
    produced = 0
    prev_tail = None
    while produced < total_frames:
        k = len(chunks)
        init = pipe.prepare_init_latents(cond_latent, chunk_frames, ts, generator, mask,
                                         None if noise is None else noise[k])
        if prev_tail is not None:
            # continue from the previous chunk: its tail re-noised at ts[0]
            eps = (torch.randn(prev_tail.shape, generator=generator, device=dev)
                   if tail_noise is None else tail_noise[k - 1].to(dev))
            t0 = torch.full((prev_tail.shape[0],), int(ts[0]), dtype=torch.long)
            init = torch.cat([add_noise(pipe.schedule, prev_tail, eps, t0), init[:, overlap:]],
                             dim=1)
        _, lat = pipe(prompt_embeds=prompt_embeds.to(dev),
                      negative_prompt_embeds=neg_embeds.to(dev), latents=init,
                      condition_latent=cond_latent, mask=mask, motion=motion, timesteps=ts,
                      guidance_scale=guidance_scale, output_type="latent")
        keep = lat if not chunks else lat[:, overlap:]
        chunks.append(keep)
        produced += keep.shape[1]
        prev_tail = lat[:, -overlap:] if overlap > 0 else None
        cond_latent = lat[:, -1:]  # the last generated frame conditions the next chunk

    latents = torch.cat(chunks, dim=1)[:, :total_frames]
    if not decode:
        return None, latents
    return decode_video(pipe.vae, latents), latents
