"""The transparent RGBA image-to-video stage-2 entry point — the port of
``animate_anything_tpu/cli_stage2.py`` (``train_transparent_i2v_stage2.py
--eval``; the reference does not publish the stage's training either):

    python -m animate_anything_tpu_torch.cli_stage2 --config configs/layerdiffuse_stage2_384.yaml \
        --eval [key.subkey=value ...] [--device cpu]

``main_eval(**cfg)``: the flagship models (``models/factory.build_models``:
a diffusers-layout directory, or random weights when
``pretrained_model_path`` is not one) and the transparent VAE pair (random,
seeded ``seed + 10`` and ``seed + 11``: the published
``vae_alpha_encoder.pth`` / ``vae_alpha_decoder.pth`` are not in the
repository); the Masked (5-channel) or Concat (9-channel) pipeline by
``in_channels``; the RGBA image (a seeded random one where it is missing)
to its premultiplied-RGB latent plus the alpha offset; an all-ones latent
mask with frame 0 frozen, a truncated DDPM init and a CFG denoise; the RGB
decode and the per-frame RGBA decode; ``decoded.gif``, ``decoded_rgba.webp``,
``decoded_alpha.webp`` and the latent motion score. It runs on the card
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from animate_anything_tpu_torch.core.config import Config, load_config
from animate_anything_tpu_torch.core.dtypes import cast_module_, policy_from_string
from animate_anything_tpu_torch.metrics.motion import latent_motion_score
from animate_anything_tpu_torch.models.factory import build_models, resolve_device
from animate_anything_tpu_torch.models.transparent_vae import (LatentTransparencyOffsetEncoder,
                                                               UNet384, UNet384Config,
                                                               build_rgba_latents)
from animate_anything_tpu_torch.pipelines.stage2 import (ConcatLatentToVideoPipeline,
                                                         MaskedLatentToVideoPipeline,
                                                         save_rgba_outputs)
from animate_anything_tpu_torch.utils import media
from animate_anything_tpu_torch.utils.convert import init_offset_encoder_, init_unet384_


def build_transparent_vae(model_size: str = "full", compute_dtype: torch.dtype = torch.float32,
                          seed: int = 0, device="cuda") -> tuple:
    """→ (offset encoder, ``UNet384``) on ``device`` in eval mode, drawn as
    the flax initialisers do from generators seeded ``seed + 10`` and
    ``seed + 11``; bf16 ``compute_dtype`` casts them to the half policy."""
    dev = resolve_device(device)
    cfg = UNet384Config.tiny() if model_size == "tiny" else UNet384Config()
    with dev:
        enc, dec = LatentTransparencyOffsetEncoder(), UNet384(cfg)
    init_offset_encoder_(enc, torch.Generator(dev).manual_seed(seed + 10))
    init_unet384_(dec, torch.Generator(dev).manual_seed(seed + 11))
    for module in (enc, dec):
        if compute_dtype != torch.float32:
            cast_module_(module)
        module.eval()
    return enc, dec


def main_eval(*, device="cuda", **cfg_kw) -> dict:
    """→ {"gif", "rgba", "alpha": the written paths, "latent_motion_score"}."""
    cfg = Config(cfg_kw)
    dev = resolve_device(device)
    out_dir = cfg.get("output_dir", "./output")
    os.makedirs(out_dir, exist_ok=True)
    policy = policy_from_string(cfg.get("mixed_precision", "bf16"))
    in_channels = int(cfg.get("in_channels", 5))
    motion_strength = bool(cfg.get("motion_strength", True))
    seed = int(cfg.get("seed") or 0)
    model_size = cfg.get("model_size", "full")

    models = build_models(cfg.get("pretrained_model_path"), motion_mask=in_channels in (5, 9),
                          motion_strength=motion_strength, model_size=model_size,
                          compute_dtype=policy.compute_dtype, attn_impl=cfg.get("attn_impl"),
                          device=dev)
    enc, dec = build_transparent_vae(model_size, policy.compute_dtype, seed, dev)
    pipe_cls = ConcatLatentToVideoPipeline if in_channels == 9 else MaskedLatentToVideoPipeline
    pipe = pipe_cls(models["unet"], models["vae"], text_encoder=models["text"],
                    tokenizer=models["tokenizer"], schedule=models["schedule"], unet384=dec)

    vd = cfg.get("validation_data", Config())
    img_path = vd.get("prompt_image")
    h, w = int(vd.get("height", 384)), int(vd.get("width", 384))
    if img_path and os.path.exists(img_path):
        rgba = media.load_image_rgba(img_path, size=(h, w))
    else:
        rgba = (np.random.default_rng(0).random((h, w, 4)) * 255).astype(np.uint8)
    pixels = torch.as_tensor(rgba, dtype=torch.float32, device=dev)[None, None] / 127.5 - 1.0
    with torch.no_grad():
        rgba_latent = build_rgba_latents(models["vae"], pixels, enc)
    hl, wl = rgba_latent.shape[2:4]

    # every location may move; the pipeline's init freezes frame 0
    mask = torch.ones((1, 1, hl, wl, 1), device=dev)
    ts = pipe.get_timesteps(int(vd.get("num_inference_steps", 10)),
                            float(vd.get("t_start_fraction", 0.0)))
    latents = pipe.prepare_init_latents(rgba_latent, int(vd.get("num_frames", 8)), ts,
                                        torch.Generator(dev).manual_seed(seed), mask=mask)
    _, out_latents, rgba_out = pipe(
        vd.get("prompt", ""), latents=latents, condition_latent=rgba_latent, mask=mask,
        motion=[float(vd.get("strength", 5))] if motion_strength else None, timesteps=ts,
        guidance_scale=float(vd.get("guidance_scale", 9)))
    paths = save_rgba_outputs(out_dir, rgba_out.cpu().numpy(), fps=int(vd.get("fps", 8)))
    paths["latent_motion_score"] = float(latent_motion_score(out_latents.float())[0])
    print(paths)
    return paths


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides=[u for u in unknown if "=" in u])
    main_eval(device=args.device, **cfg.to_dict())


if __name__ == "__main__":
    cli()
