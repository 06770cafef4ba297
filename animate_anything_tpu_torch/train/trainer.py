"""Trainer core for the mask+motion video-diffusion workload — the port of
``animate_anything_tpu/train/trainer.py`` (the full finetune; LoRA, 8-bit
Adam, checkpoints and the YAML CLI are not ported yet).

Step semantics as JAX's ``make_train_step``:

- latents from the batch or from the frozen VAE encode of the pixels
  (posterior mode), fp32; the condition latent is frame 0; the mask is
  resized to latent resolution and binarised at 0.5;
- ``motion_mask``: latents freeze-blended to the condition frame outside the
  mask; the motion condition is ``latent_motion_score`` of the blended clip,
  with the auxiliary loss 0.001·MSE(score(x̂0), score) under
  ``motion_strength``;
- ε or v target per schedule; offset noise unless the schedule is rescaled;
- whole-batch text-conditioning dropout.

The random draws (noise, t, dropout) come from outside ``loss_fn``, so a
test can feed it JAX's own; ``make_train_step`` draws them from a
``torch.Generator``. Precision as JAX's ``Policy``: the optimizer keeps fp32
masters of the trainable parameters (``core/dtypes.master_params``) and
updates them in place; the working module, whose weights the kernels read,
gets them back rounded after each update. Freezing follows JAX's flax-path
patterns through ``utils/convert.flax_path``; the optimizer is optax's
``MultiSteps(multi_transform({"train": chain(clip_by_global_norm, adamw),
"freeze": set_to_zero}))`` written out. The text encoder and the VAE run
frozen under ``torch.no_grad()``; the UNet keeps ``eval()`` mode, as JAX's
step applies it with ``deterministic=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from animate_anything_tpu_torch.core.dtypes import copy_masters_, master_params
from animate_anything_tpu_torch.diffusion.schedule import (DiffusionSchedule, add_noise,
                                                           get_velocity, make_schedule,
                                                           pred_x0, sample_noise)
from animate_anything_tpu_torch.metrics.motion import latent_motion_score
from animate_anything_tpu_torch.models.layers import resize_nearest
from animate_anything_tpu_torch.models.vae import encode_video
from animate_anything_tpu_torch.utils.convert import flax_path


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    adam_weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    trainable_modules: Tuple[str, ...] = ("all",)
    not_trainable_modules: Tuple[str, ...] = ()
    text_dropout: float = 0.15
    motion_mask: bool = False
    motion_strength: bool = False
    use_offset_noise: bool = False
    offset_noise_strength: float = 0.1
    rescale_schedule: bool = False
    motion_loss_weight: float = 0.001


def mask_motion_finetune() -> Tuple[TrainConfig, DiffusionSchedule]:
    """The flagship finetune, ``configs/train_mask_motion.yaml``: motion
    mask and strength on, zero-terminal-SNR schedule (so no offset noise),
    every parameter trained, AdamW at lr 5e-6 without weight decay.

    The objective is an assumption, not a value of the YAML: the YAML names
    no prediction type, and JAX's ``schedule_from_json`` defaults to ε when
    no scheduler config is given. The scheduler config of the published
    checkpoint decides it, and the repo does not hold that file. Until it
    does, this takes v-prediction, the objective a zero terminal SNR needs
    (ε carries no signal at ᾱ = 0, and the motion loss's
    x̂0 = (x − sqrt(1−ᾱ)·ε)/sqrt(ᾱ) divides by 0 at t = 999)."""
    config = TrainConfig(learning_rate=5e-6, adam_weight_decay=0.0, motion_mask=True,
                         motion_strength=True, rescale_schedule=True,
                         trainable_modules=("all",))
    return config, make_schedule(prediction_type="v_prediction", rescale_betas_zero_snr=True)


def trainable_label_tree(model: nn.Module, trainable_modules: Tuple[str, ...],
                         not_trainable_modules: Tuple[str, ...] = ()) -> Dict[str, str]:
    """'train' / 'freeze' per parameter name, by JAX's rule on the parameter's
    flax path: the deny-list first; 'all' trains everything; otherwise a
    parameter trains if a pattern is a substring of its path and the path
    holds no 'lora'."""

    def label(path: str) -> str:
        if any(tm in path for tm in not_trainable_modules):
            return "freeze"
        for tm in trainable_modules:
            if tm == "all" or (tm in path and "lora" not in path):
                return "train"
        return "freeze"

    return {name: label(flax_path(name, p.ndim)) for name, p in model.named_parameters()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over the tensors, in fp32 (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.stack(norms).square().sum().sqrt()


class AdamW:
    """optax's ``adamw`` after ``clip_by_global_norm``, on the trainable
    masters only, inside ``MultiSteps`` when ``gradient_accumulation_steps``
    > 1 (the running mean of the micro-steps' gradients; an update every k
    steps). In place on the fp32 masters, in chunks so the fp32 temporaries
    stay small at full width.

    Per trainable p with gradient g: g ← g·max_norm/‖g‖ when ‖g‖ ≥ max_norm
    (the norm over trainable gradients only); μ ← b1·μ + (1 − b1)·g;
    ν ← b2·ν + (1 − b2)·g²; u = μ/(1 − b1ⁿ) / (sqrt(ν/(1 − b2ⁿ)) + eps);
    p ← p − lr·(u + wd·p). Frozen parameters are never touched."""

    CHUNK = 1 << 26   # elements per foreach chunk

    def __init__(self, config: TrainConfig, masters: Dict[str, torch.Tensor]):
        self.config = config
        self.names = list(masters)
        self.mu = {n: torch.zeros_like(p) for n, p in masters.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in masters.items()}
        self.count = 0
        self.k = config.gradient_accumulation_steps
        self.mini_step = 0
        self.acc = ({n: torch.zeros_like(p) for n, p in masters.items()} if self.k > 1
                    else None)

    def _chunks(self):
        chunk, size = [], 0
        for n in self.names:
            chunk.append(n)
            size += self.mu[n].numel()
            if size >= self.CHUNK:
                yield chunk
                chunk, size = [], 0
        if chunk:
            yield chunk

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]],
             masters: Dict[str, torch.Tensor]) -> bool:
        """Take one micro-step's gradients of the trainable parameters (any
        dtype; None counts as zero). Returns whether the masters changed."""
        cfg = self.config
        grads = {n: (torch.zeros_like(self.mu[n]) if grads.get(n) is None else grads[n])
                 for n in self.names}
        if self.acc is not None:
            for chunk in self._chunks():
                acc = [self.acc[n] for n in chunk]
                g = [grads[n].float() for n in chunk]
                torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(g, acc),
                                                            float(self.mini_step + 1)))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads = self.acc
        norm = float(global_norm(grads.values())) if grads else 0.0
        clip = 1.0 if norm < cfg.max_grad_norm else cfg.max_grad_norm / norm
        self.count += 1
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for chunk in self._chunks():
            g = [grads[n].float() for n in chunk]
            if clip != 1.0:
                g = torch._foreach_mul(g, clip)
            mu, nu = [self.mu[n] for n in chunk], [self.nu[n] for n in chunk]
            p = [masters[n] for n in chunk]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.adam_eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            if cfg.adam_weight_decay:
                torch._foreach_add_(upd, p, alpha=cfg.adam_weight_decay)
            torch._foreach_add_(p, upd, alpha=-cfg.learning_rate)
        if self.acc is not None:
            for t in self.acc.values():
                t.zero_()
        return True


def make_optimizer(config: TrainConfig, masters: Dict[str, torch.Tensor]) -> AdamW:
    return AdamW(config, masters)


@dataclasses.dataclass
class TrainState:
    """The working module (compute dtypes, read by the kernels), the fp32
    masters of its trainable parameters, and their optimizer."""
    model: nn.Module
    masters: Dict[str, torch.Tensor]
    optimizer: AdamW
    labels: Dict[str, str]
    step: int = 0


def create_train_state(model: nn.Module, config: TrainConfig) -> TrainState:
    labels = trainable_label_tree(model, config.trainable_modules, config.not_trainable_modules)
    masters = master_params(model, [n for n, lab in labels.items() if lab == "train"])
    for p in model.parameters():        # frozen ones too: grad_norm counts every gradient
        p.requires_grad_(True)
    return TrainState(model, masters, make_optimizer(config, masters), labels)


def prepare_mask_for_latents(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(b, H, W) 0..255 → (b, 1, h, w, 1) fp32 in {0, 1}: /255, nearest
    resize with ``jax.image.resize``'s half-pixel convention, ≥ 0.5."""
    m = resize_nearest(mask.float()[..., None] / 255.0, (h, w))[..., 0]
    return (m >= 0.5).float()[:, None, :, :, None]


@torch.no_grad()
def batch_latents(batch: dict, vae: Optional[nn.Module] = None) -> torch.Tensor:
    """fp32 latents of a batch: its cached ``latents``, or the frozen VAE
    encode of its ``pixel_values`` (b, f, H, W, 3) in [-1, 1]."""
    if "latents" in batch:
        return batch["latents"].float()
    pixels = batch["pixel_values"]
    return encode_video(vae, pixels.to(next(vae.parameters()).dtype)).float()


def make_loss_fn(schedule: DiffusionSchedule, config: TrainConfig,
                 vae: Optional[nn.Module] = None,
                 text_encoder: Optional[nn.Module] = None) -> Callable:
    """``loss_fn(model, batch, noise, t, drop) → (loss, metrics)``, pure in its
    random draws: ``noise`` (b, f, h, w, c) fp32 with any offset added, ``t``
    (b,) int timesteps, ``drop`` the text-dropout flag. Batch keys: as JAX's
    (``latents`` or ``pixel_values``; ``mask`` (b, H, W) 0..255;
    ``encoder_hidden_states`` + ``uncond_hidden_states`` or ``prompt_ids`` +
    ``uncond_ids``)."""

    def loss_fn(model, batch, noise, t, drop):
        latents = batch_latents(batch, vae)
        b, f, h, w, _ = latents.shape
        condition_latent = latents[:, 0:1]
        mask = prepare_mask_for_latents(batch["mask"], h, w)
        if config.motion_mask:
            latents = condition_latent.expand_as(latents) * (1.0 - mask) + latents * mask
        latent_motion = latent_motion_score(latents)
        noisy = add_noise(schedule, latents, noise, t)

        with torch.no_grad():
            if "encoder_hidden_states" in batch:
                embeds, uncond = batch["encoder_hidden_states"], batch["uncond_hidden_states"]
            else:
                embeds = text_encoder(batch["prompt_ids"])
                uncond = text_encoder(batch["uncond_ids"])
        embeds = uncond if bool(drop) else embeds

        pred = model(noisy, t, embeds, condition_latent,
                     mask if config.motion_mask else None,
                     latent_motion if config.motion_strength else None)
        if schedule.prediction_type == "epsilon":
            target = noise
        elif schedule.prediction_type == "v_prediction":
            target = get_velocity(schedule, latents, noise, t)
        else:
            raise ValueError(schedule.prediction_type)
        loss = (pred.float() - target.float()).square().mean()
        metrics = {"mse_loss": loss}
        if config.motion_strength:
            x0 = pred_x0(schedule, pred, noisy, t)
            motion_loss = (latent_motion - latent_motion_score(x0)).square().mean()
            loss = loss + config.motion_loss_weight * motion_loss
            metrics["motion_loss"] = motion_loss
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def apply_gradients(state: TrainState) -> float:
    """Hand the working module's gradients to the optimizer, round updated
    masters back into it, clear the gradients; return the global norm of
    every gradient, frozen ones included (JAX's ``grad_norm``)."""
    named = dict(state.model.named_parameters())
    grads = {n: p.grad for n, p in named.items()}
    norm = global_norm([g for g in grads.values() if g is not None])
    if state.optimizer.step({n: grads[n] for n in state.masters}, state.masters):
        copy_masters_(state.model, state.masters)
    for p in named.values():
        p.grad = None
    state.step += 1
    return float(norm)


def make_train_step(schedule: DiffusionSchedule, config: TrainConfig,
                    vae: Optional[nn.Module] = None, text_encoder: Optional[nn.Module] = None,
                    device="cuda") -> Callable:
    """``train_step(state, batch, generator) → metrics`` (floats: loss,
    mse_loss, motion_loss, grad_norm). Draws noise, t and the text-dropout
    flag from ``generator`` (on ``device``), then runs ``loss_fn``, the
    backward and the optimizer. Runs on the card unless ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step: no CUDA device (pass device='cpu' for the CPU)")
    loss_fn = make_loss_fn(schedule, config, vae, text_encoder)
    offset = config.offset_noise_strength if (config.use_offset_noise
                                              and not config.rescale_schedule) else 0.0

    def train_step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
        batch["latents"] = batch_latents(batch, vae)
        b = batch["latents"].shape[0]
        noise = sample_noise(tuple(batch["latents"].shape), offset, generator=generator,
                             device=device)
        t = torch.randint(0, schedule.num_train_timesteps, (b,), generator=generator,
                          device=device)
        drop = torch.rand((), generator=generator, device=device) < config.text_dropout
        _, metrics = loss_fn(state.model, batch, noise, t, drop)
        metrics["loss"].backward()
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out["grad_norm"] = apply_gradients(state)
        return out

    return train_step
