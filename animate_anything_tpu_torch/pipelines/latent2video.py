"""LatentToVideo pipeline: masked image animation from partially noised
latents — the port of ``animate_anything_tpu/pipelines/latent2video.py``.

- sampling starts from the image latent repeated per frame and noised at
  the first timestep of the grid;
- CFG doubles the batch: [negative, positive] prompt embeddings, the same
  condition latent, mask and motion for both halves;
- the denoise loop is a plain Python loop over DPM-Solver++ (default) or
  DDIM steps (``sampler=``), then the VAE decodes every frame.

``animate_image(image, prompt)`` encodes its prompt (and the empty negative
prompt) through the pipeline's tokenizer and CLIP text encoder
(``encode_prompt``), as JAX's does; ``__call__`` takes the embeddings.

``pab``: Pyramid-Attention-Broadcast step caching (``models/pab.py``),
``{"spatial_rate": 2, "temporal_rate": 3, "warmup": 4, "tail": 1}``: each
request gets a new ``PABCache`` threaded through the sampler, and each step
its spatial and temporal reuse flags. None is the exact computation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from animate_anything_tpu_torch.diffusion import (DiffusionSchedule, ddim_timesteps,
                                                  ddpm_forward_mask, ddpm_forward_timesteps,
                                                  dpmpp_timesteps, make_schedule, sample_loop)
from animate_anything_tpu_torch.models.clip_text import CLIPTextModel
from animate_anything_tpu_torch.models.layers import resize_nearest
from animate_anything_tpu_torch.models.pab import PABCache, PABStep, unet3d_flags
from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel
from animate_anything_tpu_torch.models.vae import AutoencoderKL, decode_video, encode_video


class LatentToVideoPipeline:
    def __init__(self, unet: UNet3DConditionModel, vae: AutoencoderKL,
                 text_encoder: Optional[CLIPTextModel] = None, tokenizer=None,
                 schedule: Optional[DiffusionSchedule] = None, sampler: str = "dpmpp",
                 pab: Optional[dict] = None):
        """tokenizer: ``models/tokenizers.py::HashTokenizer`` or
        ``models/clip_tokenizer.py::CLIPBPETokenizer`` (called as HF's);
        sampler: ``"dpmpp"`` or ``"ddim"``; pab: the PAB config or None."""
        if sampler not in ("dpmpp", "ddim"):
            raise ValueError(f"unknown sampler {sampler}")
        self.pab = dict(pab) if pab else None
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.schedule = schedule or make_schedule()
        self.sampler = sampler

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @torch.no_grad()
    def encode_prompt(self, prompt, negative_prompt=""):
        """Prompt(s) → (prompt_embeds, negative_prompt_embeds), each (n, seq,
        hidden) fp32: one text-encoder call on the prompts and then the
        negatives, padded to the tokenizer's length."""
        if self.tokenizer is None or self.text_encoder is None:
            raise ValueError("pipeline built without text encoder/tokenizer")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        ids = self.tokenizer(prompts + negs, padding="max_length", truncation=True,
                             max_length=77, return_tensors="np").input_ids
        dev = next(self.text_encoder.parameters()).device
        embeds = self.text_encoder(torch.as_tensor(np.asarray(ids), device=dev))
        return embeds[:len(prompts)], embeds[len(prompts):]

    def get_timesteps(self, num_inference_steps: int,
                      t_start_fraction: float = 0.0) -> np.ndarray:
        """The sampler's grid; ``t_start_fraction`` > 0 drops that share of
        its noisiest steps (the truncated schedule)."""
        grid = dpmpp_timesteps if self.sampler == "dpmpp" else ddim_timesteps
        ts = grid(self.schedule.num_train_timesteps, num_inference_steps)
        return ts[int(len(ts) * t_start_fraction):]

    def prepare_init_latents(self, image_latent: torch.Tensor, num_frames: int,
                             timesteps: np.ndarray, generator: Optional[torch.Generator] = None,
                             mask: Optional[torch.Tensor] = None,
                             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image_latent (b, 1, h, w, 4) → (b, num_frames, h, w, 4) start latents.
        ``noise`` (fp32, the video latents' shape) overrides the generator."""
        if mask is not None:
            return ddpm_forward_mask(self.schedule, image_latent, mask, num_frames, timesteps,
                                     generator, noise)
        return ddpm_forward_timesteps(self.schedule, image_latent, num_frames, timesteps,
                                      generator, noise)

    @torch.no_grad()
    def __call__(self, prompt=None, *, prompt_embeds: Optional[torch.Tensor] = None,
                 negative_prompt_embeds: Optional[torch.Tensor] = None,
                 latents: torch.Tensor, condition_latent: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, motion=None,
                 timesteps: Optional[np.ndarray] = None, num_inference_steps: int = 25,
                 guidance_scale: float = 9.0, output_type: str = "np"):
        """Returns (video, latents); video is (b, f, 8h, 8w, 3) in [-1, 1], or
        None for ``output_type="latent"``. Without ``prompt_embeds`` the
        ``prompt`` is encoded (``encode_prompt``, the empty negative prompt);
        ``motion`` is (b,) strengths, a tensor or a list."""
        if prompt_embeds is None:
            prompt_embeds, negative_prompt_embeds = self.encode_prompt(prompt)
        if timesteps is None:
            timesteps = self.get_timesteps(num_inference_steps)
        b = latents.shape[0]
        dev = latents.device
        embeds = torch.cat([negative_prompt_embeds, prompt_embeds]).to(dev)
        cond2 = torch.cat([condition_latent, condition_latent])
        mask2 = None if mask is None else torch.cat([mask, mask])
        if motion is not None:
            motion = torch.as_tensor(motion, dtype=torch.float32, device=dev)
        motion2 = None if motion is None else torch.cat([motion, motion])
        gs = float(guidance_scale)

        def guided(x: torch.Tensor, t: int, pab=None) -> torch.Tensor:
            out = self.unet(torch.cat([x, x]), t, embeds, cond2, mask2, motion2, pab=pab)
            uncond, cond = out[:b], out[b:]
            return uncond.float() + gs * (cond - uncond).float()

        if self.pab is None:
            latents = sample_loop(self.schedule, latents, timesteps, guided, self.sampler)
        else:
            sflags, tflags = unet3d_flags(self.pab, len(timesteps))

            def model_fn(x, t, i, cache):
                flags = {"spatial": bool(sflags[i]), "temporal": bool(tflags[i])}
                return guided(x, t, PABStep(cache, flags)), cache

            latents = sample_loop(self.schedule, latents, timesteps, model_fn, self.sampler,
                                  model_state=PABCache())
        if output_type == "latent":
            return None, latents
        return decode_video(self.vae, latents), latents

    @torch.no_grad()
    def animate_image(self, image: np.ndarray, prompt: str, *,
                      mask_img: Optional[np.ndarray] = None,
                      motion_strength: Optional[float] = None, num_frames: int = 16,
                      num_inference_steps: int = 25, guidance_scale: float = 9.0,
                      t_start_fraction: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
        """Image + prompt → video: encode the prompt and the image, build the
        latent mask, seed the start latents, denoise, decode. image (h, w, 3)
        uint8; mask_img (h, w) uint8 in {0, 255}, 255 = may move."""
        dev = self.device
        pixels = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=dev)
        image_latent = encode_video(self.vae, (pixels / 127.5 - 1.0)[None, None])
        h8, w8 = image_latent.shape[2], image_latent.shape[3]

        mask = None
        if mask_img is not None:
            m = torch.as_tensor(np.asarray(mask_img, np.float32) / 255.0, device=dev)
            m = resize_nearest(m[None, :, :, None], (h8, w8))[0, :, :, 0]
            mask = (m >= 0.5).float()[None, None, :, :, None]

        ts = self.get_timesteps(num_inference_steps, t_start_fraction)
        latents = self.prepare_init_latents(image_latent, num_frames, ts, generator, mask, noise)
        motion = None if motion_strength is None else torch.tensor(
            [motion_strength], dtype=torch.float32, device=dev)
        prompt_embeds, negative_prompt_embeds = self.encode_prompt(prompt)
        return self(prompt_embeds=prompt_embeds.to(dev),
                    negative_prompt_embeds=negative_prompt_embeds.to(dev),
                    latents=latents, condition_latent=image_latent, mask=mask, motion=motion,
                    timesteps=ts, guidance_scale=guidance_scale)
