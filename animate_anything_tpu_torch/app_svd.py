"""Headless SVD image-to-video / video-to-video controller — the port of the
root ``app_svd.py``'s ``AnimateController`` (no gradio UI).

- a given video's per-frame VAE latents become the condition latents (v2v;
  its first frame is the image, its length the frame count);
- a UNet of 9 input channels takes the motion mask: the request's, snapped
  to the latent grid (nearest), or all ones; an 8-channel UNet none;
- the guidance scale is a per-frame linspace from ``min_cfg`` to
  ``max_cfg``, seeded by the request's seed.

The weights are random, drawn from a seed, as JAX's ``build_svd_models``
draws them (``pretrained_model_path`` is kept for the same signature); the
models run in ``mixed_precision`` (bf16 by default; JAX's controller builds
fp32) under ``attn_impl`` on ``device``.

    python -m animate_anything_tpu_torch.app_svd --config configs/train_svd_mask.yaml \\
        --image in.png --out out.gif
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


class AnimateController:
    def __init__(self, pretrained_model_path=None, validation_data=None,
                 output_dir="output/app_svd", model_size="full", motion_mask=True,
                 attn_impl=None, mixed_precision="bf16", device="cuda"):
        from animate_anything_tpu_torch.cli_svd import build_svd_models
        from animate_anything_tpu_torch.core.config import Config
        from animate_anything_tpu_torch.core.dtypes import policy_from_string
        from animate_anything_tpu_torch.models.factory import resolve_device
        from animate_anything_tpu_torch.pipelines.svd import TextStableVideoDiffusionPipeline

        self.device = resolve_device(device)
        self.validation_data = Config(validation_data or {})
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        models = build_svd_models(
            motion_mask=motion_mask, model_size=model_size, attn_impl=attn_impl,
            compute_dtype=policy_from_string(mixed_precision).compute_dtype, device=self.device)
        self.in_channels = models["unet_config"].in_channels
        self.pipeline = TextStableVideoDiffusionPipeline(
            models["unet"], models["vae"], image_encoder=models["image_encoder"])
        self.sample_idx = 0

    def animate(self, image, video_frames=None, mask_img=None, steps=25, min_cfg=1.0,
                max_cfg=3.0, seed=0):
        """image (h, w, 3) uint8; video_frames (f, h, w, 3) uint8 for v2v;
        mask_img (h, w) uint8, 255 = may move. → the gif's path."""
        from animate_anything_tpu_torch.models.layers import resize_nearest
        from animate_anything_tpu_torch.utils import media

        vd = self.validation_data
        num_frames = int(vd.get("num_frames", 14))
        image = np.array(image)  # a writable copy: decoded images may be read-only
        cond = None
        if video_frames is not None:
            cond = self.pipeline.video_to_condition_latent(np.asarray(video_frames))
            num_frames = cond.shape[1]
            image = np.asarray(video_frames[0])
        h8, w8 = image.shape[0] // 8, image.shape[1] // 8
        mask = None
        if self.in_channels == 9:  # the mask routing
            if mask_img is not None:
                m = (np.asarray(mask_img, np.float32) / 255.0 >= 0.5).astype(np.float32)
                m = resize_nearest(torch.as_tensor(m, device=self.device)[None, :, :, None],
                                   (h8, w8))[0, :, :, 0]
                mask = m[None, None, :, :, None]
            else:
                mask = torch.ones((1, 1, h8, w8, 1), device=self.device)
        video, _ = self.pipeline(
            image, condition_latent=cond, mask=mask, num_frames=num_frames,
            num_inference_steps=int(steps), min_guidance_scale=float(min_cfg),
            max_guidance_scale=float(max_cfg),
            decode_chunk_size=int(vd.get("decode_chunk_size", 0)) or None,
            fps=int(vd.get("fps", 7)), motion_bucket_id=int(vd.get("motion_bucket_id", 127)),
            generator=torch.Generator(self.device).manual_seed(int(seed)))
        path = os.path.join(self.output_dir, f"{self.sample_idx}.gif")
        media.save_gif(path, media.to_uint8(video[0].float().cpu().numpy()),
                       fps=int(vd.get("fps", 7)))
        self.sample_idx += 1
        return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--image", type=str, default=None)
    ap.add_argument("--video", type=str, default=None)
    ap.add_argument("--mask", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args, unknown = ap.parse_known_args(argv)

    from animate_anything_tpu_torch.utils import media

    cfg = {}
    if args.config:
        from animate_anything_tpu_torch.core.config import load_config

        cfg = load_config(args.config, [u for u in unknown if "=" in u]).to_dict()
    controller = AnimateController(
        cfg.get("pretrained_model_path"), cfg.get("validation_data"),
        output_dir=cfg.get("output_dir", "output/app_svd"),
        model_size=cfg.get("model_size", "full"), motion_mask=bool(cfg.get("motion_mask", True)),
        attn_impl=cfg.get("attn_impl"), mixed_precision=cfg.get("mixed_precision", "bf16"),
        device=args.device)
    video = media.load_video_frames(args.video) if args.video else None
    image = media.load_image(args.image) if args.image else video[0]
    mask = np.asarray(media.load_image(args.mask))[..., 0] if args.mask else None
    path = controller.animate(image, video, mask, steps=args.steps, seed=args.seed)
    if args.out:
        os.replace(path, args.out)
        path = args.out
    print(path)


if __name__ == "__main__":
    main()
