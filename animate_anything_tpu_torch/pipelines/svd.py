"""SVD pipelines: masked image → video and the text / video-to-video variant
— the port of ``animate_anything_tpu/pipelines/svd.py``.

- conditioning: the CLIP image embedding (the unconditional half zeros) and
  the VAE latents of the noise-augmented image, divided by the VAE's
  scaling factor and repeated per frame (the unconditional half zeros),
  joined to the noisy latents on the channel axis each step; the motion
  mask, when given, FIRST (9-channel UNets);
- a per-frame guidance scale, linspace(min, max) over the frames;
- Euler steps over Karras σ with the EDM parameterisation
  (``diffusion/euler_edm.py``), as a plain Python loop;
- micro-conditioning ``added_time_ids`` = (fps − 1, motion bucket, noise
  augmentation);
- v2v: per-frame condition latents from an input video
  (``TextStableVideoDiffusionPipeline.video_to_condition_latent``);
- ``condition_type`` image / text / both for the encoder states.

``pab``: PAB step caching (``models/pab.py``), ``{"rate": 2, "warmup": 4,
"tail": 1}``: one reuse flag a step for every spatio-temporal transformer,
a new ``PABCache`` each request.

Randomness comes from an explicit ``torch.Generator``; ``noise`` (the start
latents' N(0, 1)) and ``aug_noise`` (the image's augmentation N(0, 1))
override it, so a caller can feed in any other source's draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from animate_anything_tpu_torch.diffusion.euler_edm import (euler_step, make_euler_schedule,
                                                            scale_model_input)
from animate_anything_tpu_torch.models.clip_vision import preprocess_clip_image
from animate_anything_tpu_torch.models.pab import PABCache, PABStep, svd_flags
from animate_anything_tpu_torch.models.vae import decode_video, encode_video


class MaskStableVideoDiffusionPipeline:
    def __init__(self, unet, vae, image_encoder=None, text_encoder=None, tokenizer=None,
                 pab: Optional[dict] = None):
        self.pab = dict(pab) if pab else None
        self.unet = unet
        self.vae = vae
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @torch.no_grad()
    def encode_image_embedding(self, image_uint8: np.ndarray) -> torch.Tensor:
        """(h, w, 3) uint8 → (1, 1, projection_dim)."""
        if self.image_encoder is None:
            raise ValueError("pipeline built without an image encoder")
        px = preprocess_clip_image(image_uint8, self.image_encoder.config.image_size)
        emb = self.image_encoder(torch.as_tensor(px, device=self.device))
        return emb[:, None, :]

    @torch.no_grad()
    def encode_text_embedding(self, prompt: str) -> torch.Tensor:
        """prompt → (1, 77, hidden), the text encoder's last hidden state."""
        if self.tokenizer is None or self.text_encoder is None:
            raise ValueError("pipeline built without a text encoder and tokenizer")
        ids = self.tokenizer([prompt], padding="max_length", truncation=True, max_length=77,
                             return_tensors="np").input_ids
        return self.text_encoder(torch.as_tensor(np.asarray(ids), device=self.device))

    @torch.no_grad()
    def __call__(self, image: Optional[np.ndarray] = None, *,
                 image_embeddings: Optional[torch.Tensor] = None,
                 condition_latent: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None, prompt: Optional[str] = None,
                 condition_type: str = "image", num_frames: int = 14,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0, fps: int = 7, motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02, decode_chunk_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None, aug_noise: Optional[torch.Tensor] = None,
                 output_type: str = "np"):
        """image (h, w, 3) uint8; image_embeddings (1, L, d); condition_latent
        (b, 1 or f, h/8, w/8, 4) scaled latents; mask (b, 1, h/8, w/8, 1),
        1 = may move. Returns (video, latents): video (b, f, h, w, 3) in
        [-1, 1] (None for ``output_type="latent"``)."""
        dev = self.device
        if image_embeddings is None:
            if condition_type == "text" or (condition_type == "both" and image is None):
                image_embeddings = self.encode_text_embedding(prompt or "")
            else:
                image_embeddings = self.encode_image_embedding(image)
                if condition_type == "both" and prompt:
                    text = self.encode_text_embedding(prompt)
                    dt = torch.promote_types(image_embeddings.dtype, text.dtype)  # as jnp
                    image_embeddings = torch.cat([image_embeddings.to(dt), text.to(dt)], dim=1)
        image_embeddings = image_embeddings.to(dev)
        embeds2 = torch.cat([torch.zeros_like(image_embeddings), image_embeddings])

        if condition_latent is None:
            pixels = torch.as_tensor(np.asarray(image), dtype=torch.float32,
                                     device=dev)[None, None] / 127.5 - 1.0
            if aug_noise is None:
                aug_noise = torch.randn(pixels.shape, generator=generator, device=dev)
            pixels = pixels + noise_aug_strength * aug_noise.to(dev, torch.float32)
            condition_latent = encode_video(self.vae, pixels)
        cond = condition_latent.to(dev) / self.vae.config.scaling_factor
        if cond.shape[1] == 1:
            cond = cond.repeat_interleave(num_frames, dim=1)
        cond2 = torch.cat([torch.zeros_like(cond), cond])

        b, _, h, w, _ = cond.shape
        mask2 = None
        if mask is not None:
            m = mask.to(dev, cond.dtype).expand(b, num_frames, h, w, 1)
            mask2 = torch.cat([m, m])

        added = torch.tensor([[fps - 1, motion_bucket_id, noise_aug_strength]],
                             dtype=torch.float32, device=dev).expand(2 * b, 3)
        guidance = torch.linspace(min_guidance_scale, max_guidance_scale, num_frames,
                                  device=dev).reshape(1, num_frames, 1, 1, 1)

        es = make_euler_schedule(num_inference_steps, device=dev)
        shape = (b, num_frames, h, w, 4)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=dev)
        x = (noise.to(dev, torch.float32) * es.init_noise_sigma).to(cond.dtype)
        flags = None if self.pab is None else svd_flags(self.pab, num_inference_steps)
        cache = None if self.pab is None else PABCache()
        for i in range(num_inference_steps):
            sigma, sigma_next = es.sigmas[i], es.sigmas[i + 1]
            inp = torch.cat([scale_model_input(torch.cat([x, x]), sigma), cond2], dim=-1)
            if mask2 is not None:
                inp = torch.cat([mask2, inp], dim=-1)
            pab = None if cache is None else PABStep(cache, bool(flags[i]))
            out = self.unet(inp, es.timesteps[i], embeds2, added, pab=pab)
            uncond, cnd = out[:b], out[b:]
            x = euler_step(x, uncond + guidance * (cnd - uncond), sigma, sigma_next)
        if output_type == "latent":
            return None, x
        return decode_video(self.vae, x, chunk_size=decode_chunk_size), x


class TextStableVideoDiffusionPipeline(MaskStableVideoDiffusionPipeline):
    """The v2v and text-conditioned variant: ``condition_latent`` computed per
    frame from an input video, and/or ``condition_type`` text or both. A
    9-channel UNet takes the caller's ``mask``."""

    @torch.no_grad()
    def video_to_condition_latent(self, video_uint8: np.ndarray) -> torch.Tensor:
        """(f, h, w, 3) uint8 → (1, f, h/8, w/8, 4) scaled latents."""
        pixels = torch.as_tensor(np.asarray(video_uint8), dtype=torch.float32,
                                 device=self.device)[None] / 127.5 - 1.0
        return encode_video(self.vae, pixels)
