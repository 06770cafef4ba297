"""The eval entry point — the port of ``animate_anything_tpu/cli.py``'s
``main_eval`` (``train.py --eval``):

    python -m animate_anything_tpu_torch.cli --config configs/train_mask_motion.yaml --eval \
        [key.subkey=value ...] [--device cpu]

``main_eval(**cfg)`` builds the models (``models/factory.build_models``:
a diffusers-layout directory, or random weights when
``pretrained_model_path`` is not a directory), animates the validation image
``eval_iters`` times and reports the motion metrics. It runs on the card
unless ``device="cpu"`` is passed. The LoRA merge, PAB step caching and the
training loop (``cli`` without ``--eval``) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Optional

import numpy as np
import torch

from animate_anything_tpu_torch.core.config import Config, load_config
from animate_anything_tpu_torch.core.dtypes import policy_from_string
from animate_anything_tpu_torch.metrics.motion import (calculate_motion_precision,
                                                       latent_motion_score)
from animate_anything_tpu_torch.models.factory import build_models, resolve_device
from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
from animate_anything_tpu_torch.utils import media


def _build_pipeline(models, sampler: str = "dpmpp") -> LatentToVideoPipeline:
    return LatentToVideoPipeline(models["unet"], models["vae"], text_encoder=models["text"],
                                 tokenizer=models["tokenizer"], schedule=models["schedule"],
                                 sampler=sampler)


def run_validation(models, validation_data: Config, output_dir: str, step: int,
                   motion_mask: bool, motion_strength: bool,
                   generator: Optional[torch.Generator] = None, eval_index: int = 0,
                   sampler: str = "dpmpp", noise: Optional[torch.Tensor] = None) -> dict:
    """Animate the validation image, write the sample, report the motion
    metrics (the sample a gif with an mp4 sidecar, the mask a jpg).
    ``noise`` (the start latents' noise) overrides ``generator``."""
    pipe = _build_pipeline(models, sampler)
    vd = validation_data
    img_path = vd.get("prompt_image")
    h = int(vd.get("height", 512))
    w = int(vd.get("width", 512))
    if img_path and os.path.exists(img_path):
        # the image's native aspect rescaled to the validation area, /8
        image = media.fit_image_to_area(img_path, h, w, multiple=8)
    else:
        image = (np.random.default_rng(0).random((h // 8 * 8, w // 8 * 8, 3))
                 * 255).astype(np.uint8)

    mask_path = vd.get("mask")
    mask_img = None
    if mask_path and os.path.exists(mask_path):
        mask_img = (
            media.read_labelme_mask(mask_path, image.shape[:2])
            if mask_path.endswith(".json")
            else np.asarray(media.load_image(mask_path, image.shape[:2]))[..., 0]
        )
        mask_img = np.where(mask_img != 0, 255, 0).astype(np.uint8)
    elif motion_mask:
        mask_img = np.full(image.shape[:2], 255, np.uint8)

    if generator is None and noise is None:
        generator = torch.Generator(pipe.device).manual_seed(step)
    video, latents = pipe.animate_image(
        image,
        vd.get("prompt", ""),
        mask_img=mask_img,
        # strength = index + 3 across eval iterations unless the config sets it
        motion_strength=float(vd.get("strength", eval_index + 3)) if motion_strength else None,
        num_frames=int(vd.get("num_frames", 16)),
        num_inference_steps=int(vd.get("num_inference_steps", 25)),
        guidance_scale=float(vd.get("guidance_scale", 9)),
        generator=generator,
        noise=noise,
    )
    frames = media.to_uint8(video[0].float().cpu().numpy())
    out = os.path.join(output_dir, "samples", f"step_{step}.gif")
    media.save_gif(out, frames, fps=int(vd.get("fps", 8)))
    media.save_video(os.path.splitext(out)[0] + ".mp4", frames, fps=int(vd.get("fps", 8)))
    if mask_img is not None:
        media.save_image(os.path.splitext(out)[0] + "_mask.jpg", mask_img)

    metrics: dict[str, Any] = {"sample_path": out}
    if mask_img is not None:
        metrics["motion_precision"] = calculate_motion_precision(frames, mask_img)
    metrics["latent_motion_score"] = float(latent_motion_score(latents.float())[0])
    return metrics


def _refuse_unported(cfg: Config) -> None:
    if cfg.get("lora_path") or cfg.get("lora_text_path"):
        raise ValueError("lora_path / lora_text_path: the LoRA merge is not ported yet "
                         "(ROADMAP queue B, item 6)")
    if cfg.get("pab"):
        raise ValueError("pab: Pyramid-Attention-Broadcast step caching is not ported yet "
                         "(ROADMAP queue E, item 17)")


def eval_models(cfg: Config, device="cuda") -> dict:
    """The models ``main_eval`` runs for ``cfg``; the schedule unrescaled, as
    JAX's ``main_eval`` builds it (``rescale_schedule`` is not passed)."""
    return build_models(
        cfg.get("pretrained_model_path"),
        motion_mask=bool(cfg.get("motion_mask", False)),
        motion_strength=bool(cfg.get("motion_strength", False)),
        model_size=cfg.get("model_size", "full"),
        compute_dtype=policy_from_string(cfg.get("mixed_precision", "bf16")).compute_dtype,
        attn_impl=cfg.get("attn_impl"),
        device=device,
    )


def main_eval(*, device="cuda", **cfg_kw) -> dict:
    """Batch eval: ``eval_iters`` validation samples (iteration i seeded i,
    strength i + 3), each printed; returns the last one's metrics, with the
    mean motion precision where there is a mask."""
    cfg = Config(cfg_kw)
    _refuse_unported(cfg)
    dev = resolve_device(device)
    output_dir = cfg.get("output_dir", "./output")
    os.makedirs(output_dir, exist_ok=True)
    motion_mask = bool(cfg.get("motion_mask", False))
    motion_strength = bool(cfg.get("motion_strength", False))
    models = eval_models(cfg, dev)
    iters = int(cfg.get("eval_iters", 1))
    precisions = []
    out: dict = {}
    for i in range(iters):
        metrics = run_validation(
            models, cfg.get("validation_data", Config()), output_dir, i,
            motion_mask, motion_strength, generator=torch.Generator(dev).manual_seed(i),
            eval_index=i)
        print(metrics)
        if "motion_precision" in metrics:
            precisions.append(metrics["motion_precision"])
        out = metrics
    if precisions:
        out["mean_motion_precision"] = float(np.mean(precisions))
        print(f"mean motion precision: {out['mean_motion_precision']:.4f}")
    return out


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides=[u for u in unknown if "=" in u])
    if not args.eval:
        raise ValueError("training (cli without --eval) is not ported yet "
                         "(ROADMAP queue B, item 10); pass --eval")
    main_eval(device=args.device, **cfg.to_dict())


if __name__ == "__main__":
    cli()
