"""Model assembly from a diffusers-layout checkpoint or from random weights —
the port of ``animate_anything_tpu/models/factory.py``.

``build_models`` reads the scheduler, tokenizer, CLIP text encoder, VAE and
UNet of a pipeline directory (``train/checkpoint.py``), including the
conv_in → conv_in2 surgery when a checkpoint without the mask channel is
adapted for motion-mask use; with no directory it draws every weight as the
flax initialisers do (``utils/convert.py``) from explicit generators. The
modules are built on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import fields
from typing import Optional

import torch

from animate_anything_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_module_
from animate_anything_tpu_torch.diffusion import make_schedule
from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig


def unet_config_from_json(cfg: dict, **overrides) -> UNet3DConfig:
    """A ``unet/config.json`` (diffusers', or either package's dataclass dump)
    → ``UNet3DConfig``; keys it has no field for are ignored."""
    keys = {f.name for f in fields(UNet3DConfig)}
    kw = {k: v for k, v in cfg.items() if k in keys}
    for k in ("down_block_types", "up_block_types", "block_out_channels"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if isinstance(kw.get("attention_head_dim"), (list, tuple)):
        kw["attention_head_dim"] = kw["attention_head_dim"][0]
    kw.update(overrides)
    return UNet3DConfig(**kw)


def vae_config_from_json(cfg: dict) -> VAEConfig:
    keys = {f.name for f in fields(VAEConfig)}
    kw = {k: v for k, v in cfg.items() if k in keys}
    if "block_out_channels" in kw:
        kw["block_out_channels"] = tuple(kw["block_out_channels"])
    return VAEConfig(**kw)


def clip_config_from_json(cfg: dict) -> CLIPTextConfig:
    """Both HF ``CLIPTextConfig`` json keys and the dataclass dump."""
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 1024),
        num_layers=cfg.get("num_hidden_layers", cfg.get("num_layers", 23)),
        num_heads=cfg.get("num_attention_heads", cfg.get("num_heads", 16)),
        intermediate_size=cfg.get("intermediate_size", 4096),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "gelu"),
    )


def schedule_from_json(cfg: dict, rescale: bool = False):
    return make_schedule(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        rescale_betas_zero_snr=rescale,
    )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (nothing
    falls back to the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); pass "
                           "device='cpu' to run on the CPU")
    return dev


def _tokenizer(pretrained_model_path: Optional[str], from_ckpt: bool,
               tcfg: CLIPTextConfig):
    """A checkpoint's ``tokenizer/`` directory through the in-package BPE
    tokenizer; a directory that is present but cannot be loaded is an error
    (unless ``AA_ALLOW_HASH_TOKENIZER=1``), since the hash vocab would feed a
    real checkpoint meaningless ids; with no directory, the asset-free
    ``HashTokenizer``, with a warning when a checkpoint lacks one."""
    if from_ckpt:
        tok_dir = os.path.join(pretrained_model_path, "tokenizer")
        if os.path.isdir(tok_dir):
            try:
                from animate_anything_tpu_torch.models.clip_tokenizer import CLIPBPETokenizer

                return CLIPBPETokenizer.from_pretrained(
                    tok_dir, model_max_length=tcfg.max_position_embeddings)
            except Exception as e:
                if os.environ.get("AA_ALLOW_HASH_TOKENIZER") != "1":
                    raise RuntimeError(
                        f"checkpoint tokenizer dir {tok_dir!r} exists but could not be "
                        f"loaded ({e}); refusing to silently substitute the hash tokenizer "
                        "(set AA_ALLOW_HASH_TOKENIZER=1 to override)") from e
        else:
            warnings.warn(
                "no tokenizer/ dir in checkpoint: using the asset-free HashTokenizer — token "
                "ids will NOT match CLIP; prompts on real checkpoints will be meaningless",
                stacklevel=3)
    return HashTokenizer(tcfg.vocab_size, tcfg.max_position_embeddings)


def build_models(
    pretrained_model_path: Optional[str] = None,
    motion_mask: bool = False,
    motion_strength: bool = False,
    model_size: str = "full",       # 'full' | 'tiny' (tests)
    compute_dtype: torch.dtype = torch.float32,
    rescale_schedule: bool = False,
    attn_impl: Optional[str] = None,
    gradient_checkpointing: bool = False,
    seed: int = 0,
    device="cuda",
) -> dict:
    """→ dict(unet, unet_config, vae, vae_config, text, text_config,
    tokenizer, schedule), the modules on ``device`` in eval mode.

    ``compute_dtype`` bf16 casts each module to the half policy
    (``core/dtypes.cast_module_``); fp32 keeps it. Random weights (no
    checkpoint directory, or a component missing from it) come from
    generators seeded ``seed``, ``seed + 1`` and ``seed + 2`` for the UNet,
    VAE and text encoder; a checkpoint's weights load with ``strict=True``."""
    from animate_anything_tpu_torch.train.checkpoint import load_pipeline_components
    from animate_anything_tpu_torch.utils.convert import (checkpoint_state_dict,
                                                          init_clip_text_, init_unet3d_,
                                                          init_vae_)

    dev = resolve_device(device)
    if compute_dtype not in (torch.float32, COMPUTE_DTYPE):
        raise ValueError(f"compute_dtype must be float32 or {COMPUTE_DTYPE}, got {compute_dtype}")
    from_ckpt = bool(pretrained_model_path) and os.path.isdir(pretrained_model_path)
    comp = load_pipeline_components(pretrained_model_path) if from_ckpt else {}

    ukw = dict(motion_mask=motion_mask, motion_strength=motion_strength, attn_impl=attn_impl,
               gradient_checkpointing=gradient_checkpointing)
    if "unet_config" in comp:
        ucfg = unet_config_from_json(comp["unet_config"], **ukw)
    elif model_size == "tiny":
        ucfg = UNet3DConfig.tiny(**ukw)
    else:
        ucfg = UNet3DConfig(**ukw)
    if "vae_config" in comp:
        vcfg = vae_config_from_json(comp["vae_config"])
    else:
        vcfg = VAEConfig.tiny() if model_size == "tiny" else VAEConfig()
    if "text_config" in comp:
        tcfg = clip_config_from_json(comp["text_config"])
    elif model_size == "tiny":
        tcfg = CLIPTextConfig.tiny(hidden_size=ucfg.cross_attention_dim)
    else:
        tcfg = CLIPTextConfig()

    with dev:
        unet = UNet3DConditionModel(ucfg)
        vae = AutoencoderKL(vcfg)
        text = CLIPTextModel(tcfg)
    for i, (name, module, init) in enumerate((("unet", unet, init_unet3d_),
                                              ("vae", vae, init_vae_),
                                              ("text_encoder", text, init_clip_text_))):
        if name in comp:
            sd = checkpoint_state_dict(name, comp.pop(name), motion_mask=ucfg.motion_mask)
            module.load_state_dict(sd, strict=True)
        else:
            init(module, torch.Generator(device=dev).manual_seed(seed + i))
        if compute_dtype != torch.float32:
            cast_module_(module)
        module.eval()

    return dict(
        unet=unet, unet_config=ucfg, vae=vae, vae_config=vcfg, text=text, text_config=tcfg,
        tokenizer=_tokenizer(pretrained_model_path, from_ckpt, tcfg),
        schedule=schedule_from_json(comp.get("scheduler_config", {}), rescale=rescale_schedule),
    )
