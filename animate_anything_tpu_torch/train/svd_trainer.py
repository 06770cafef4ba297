"""SVD training step: the EDM objective with mask conditioning — the port of
``animate_anything_tpu/train/svd_trainer.py``.

Step semantics as JAX's ``make_svd_train_step``:

- latents: the frozen VAE encode of the clip (posterior mode × scaling);
  the image latent: frame 0 plus lognormal noise augmentation
  ``noise_aug = exp(-3 + 0.5·N)``, encoded alone;
- ``motion_mask``: the latent mask with frame 0 forced to 0 (the first frame
  is always given), the condition latents blended from the clip's latents
  and the image latent by it;
- the CLIP image embedding of the preprocessed frame 0 (or the batch's
  ``image_embeddings``), dropped to zeros with probability 0.15;
- EDM: σ ~ exp(N(0.7, 1.6)), c_skip / c_out / c_in / c_noise and
  λ(σ) = (σ² + 1)/σ², the noisy latents in fp32;
- input channels ``[mask?, c_in·noisy, condition / scaling]`` and
  ``added_time_ids = (fps, motion_bucket_id, noise_aug)``;
- loss λ·MSE(x̂0, latents), plus the MSE over the frozen region under
  ``motion_mask``.

Where JAX departs from the reference trainer the port follows JAX: one
``noise_aug`` and one dropout draw for the whole batch (the reference draws
per sample), and the per-batch context of ``BroadcastCrossAttention``
(ROADMAP queue 3, "Recorded in the reference").

As in ``train/trainer.py``, the random draws come from outside the loss
(``draw_svd_inputs``, from an explicit ``torch.Generator``), so a test can
feed it JAX's own; the update is the same ``TrainState`` / ``AdamW`` /
``apply_gradients``. The VAE and the image encoder run frozen under
``torch.no_grad()``; the UNet keeps ``eval()`` mode, as JAX applies it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from animate_anything_tpu_torch.diffusion.euler_edm import edm_precondition, edm_sample_sigmas
from animate_anything_tpu_torch.models.vae import encode_video
from animate_anything_tpu_torch.train.trainer import (TrainConfig, _check_device,
                                                      apply_gradients, global_rows,
                                                      mean_metrics, prepare_mask_for_latents,
                                                      rows_of)
from animate_anything_tpu_torch.utils.tracing import span, sync


@dataclasses.dataclass(frozen=True)
class SVDTrainConfig(TrainConfig):
    p_mean: float = 0.7
    p_std: float = 1.6
    fps: int = 7
    motion_bucket_id: int = 127
    image_dropout: float = 0.15


@dataclasses.dataclass(frozen=True)
class SVDDraws:
    """A step's random values: the augmentation level ``noise_aug`` (a
    0-d fp32 tensor, one for the batch), the augmentation noise of frame 0
    (b, H, W, 3), σ (b, 1, 1, 1, 1), the latent noise (b, f, h, w, c) and the
    image-embedding dropout flag (one for the batch)."""
    noise_aug: torch.Tensor
    image_noise: torch.Tensor
    sigma: torch.Tensor
    noise: torch.Tensor
    drop: torch.Tensor


def draw_svd_inputs(config: SVDTrainConfig, pixel_shape: tuple, latent_channels: int,
                    generator: torch.Generator, device) -> SVDDraws:
    """A step's draws from ``generator`` for pixels of ``pixel_shape``
    (b, f, H, W, 3): the order is fixed (augmentation, σ, noise, dropout)."""
    b, f, hh, ww, c = pixel_shape
    z = torch.randn((), generator=generator, device=device)
    noise_aug = torch.exp(-3.0 + 0.5 * z)
    image_noise = torch.randn((b, hh, ww, c), generator=generator, device=device)
    sigma = edm_sample_sigmas(b, generator, config.p_mean, config.p_std, device=device)
    noise = torch.randn((b, f, hh // 8, ww // 8, latent_channels), generator=generator,
                        device=device)
    drop = torch.rand((), generator=generator, device=device) < config.image_dropout
    return SVDDraws(noise_aug, image_noise, sigma, noise, drop)


def make_svd_loss_fn(config: SVDTrainConfig, vae: nn.Module,
                     image_encoder: Optional[nn.Module] = None) -> Callable:
    """``loss_fn(model, batch, draws) → (loss, metrics)``, pure in its random
    draws (``SVDDraws``). Batch keys as JAX's: ``pixel_values`` (b, f, H, W,
    3) in [-1, 1]; ``mask`` (b, H, W) 0..255 under ``motion_mask``;
    ``clip_pixel_values`` (b, 224, 224, 3) preprocessed for the image
    encoder, or ``image_embeddings`` (b, 1, d)."""
    scaling = vae.config.scaling_factor

    def loss_fn(model, batch, draws: SVDDraws):
        pixels = batch["pixel_values"]
        vae_dt = next(vae.parameters()).dtype
        b, f = pixels.shape[:2]
        with torch.no_grad():
            latents = encode_video(vae, pixels.to(vae_dt))
            image = pixels[:, 0].float() + draws.noise_aug * draws.image_noise
            image_latent = encode_video(vae, image[:, None].to(vae_dt))
        h, w = latents.shape[2:4]

        if config.motion_mask:
            mask = prepare_mask_for_latents(batch["mask"], h, w).expand(b, f, h, w, 1).clone()
            mask[:, 0] = 0.0                    # the first frame is always given
            freeze = image_latent.expand_as(latents)
            condition_latent = latents * (1.0 - mask) + freeze * mask
        else:
            mask = None
            condition_latent = image_latent.expand_as(latents)

        if "image_embeddings" in batch:
            embeds = batch["image_embeddings"]
        else:
            with torch.no_grad():
                embeds = image_encoder(batch["clip_pixel_values"])[:, None, :]
        if sync(bool, draws.drop):
            embeds = torch.zeros_like(embeds)

        c = edm_precondition(draws.sigma)
        lat32 = latents.float()
        noisy = lat32 + draws.noise * c.sigma
        inp = torch.cat([(c.c_in * noisy).to(latents.dtype),
                         (condition_latent / scaling).to(latents.dtype)], dim=-1)
        if config.motion_mask:
            inp = torch.cat([mask.to(latents.dtype), inp], dim=-1)
        added = torch.stack([torch.full((b,), float(config.fps), device=pixels.device),
                             torch.full((b,), float(config.motion_bucket_id),
                                        device=pixels.device),
                             draws.noise_aug.float().expand(b)], dim=1)

        pred = model(inp, c.c_noise, embeds, added)
        x0 = c.c_out * pred.float() + c.c_skip * noisy
        loss = ((x0 - lat32).square() * c.loss_weight).mean()
        metrics = {"edm_loss": loss}
        if config.motion_mask:
            frozen = ((x0 - condition_latent.float()) * (1.0 - mask)).square().mean()
            loss = loss + frozen
            metrics["mask_consistency_loss"] = frozen
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def draw_svd_rows(config: SVDTrainConfig, pixel_shape: tuple, latent_channels: int,
                  generator: torch.Generator, device, mesh=None) -> SVDDraws:
    """``draw_svd_inputs`` for the global batch (every data rank draws the
    same values), then this rank's rows of the image noise, σ and the latent
    noise; the augmentation level and the dropout flag are one for the
    batch, as in JAX."""
    b = global_rows(mesh, pixel_shape[0])
    d = draw_svd_inputs(config, (b,) + tuple(pixel_shape[1:]), latent_channels, generator,
                        device)
    rows = rows_of(mesh, b)
    return SVDDraws(d.noise_aug, d.image_noise[rows], d.sigma[rows], d.noise[rows], d.drop)


def make_svd_train_step(config: SVDTrainConfig, vae: nn.Module,
                        image_encoder: Optional[nn.Module] = None, device="cuda",
                        mesh=None) -> Callable:
    """``train_step(state, batch, generator) → metrics`` (floats: edm_loss,
    mask_consistency_loss under ``motion_mask``, loss, grad_norm) for a
    full-finetune ``TrainState`` of the SVD UNet: the draws from
    ``generator`` (on ``device``), the loss, the backward, the optimizer.
    Runs on the card unless ``device="cpu"``. ``mesh``: data parallelism,
    as ``trainer.make_train_step`` (the batch is this rank's rows)."""
    device = _check_device(device, "make_svd_train_step")
    loss_fn = make_svd_loss_fn(config, vae, image_encoder)
    channels = vae.config.latent_channels

    def train_step(state, batch: dict, generator: torch.Generator) -> dict:
        with span("train_step"):
            with span("inputs"):
                batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                         for k, v in batch.items()}
                draws = draw_svd_rows(config, tuple(batch["pixel_values"].shape), channels,
                                      generator, device, mesh)
            with span("loss"):
                _, metrics = loss_fn(state.model, batch, draws)
            with span("backward"):
                metrics["loss"].backward()
            with span("metrics"):
                out = mean_metrics(metrics, state)
            out["grad_norm"] = apply_gradients(state)
            return out

    return train_step
