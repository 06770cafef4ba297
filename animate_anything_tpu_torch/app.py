"""Headless masked-animation controller — the port of the root ``app.py``'s
``AnimateController`` (no gradio UI).

``AnimateController.animate`` keeps the demo's semantics:

- the motion mask comes from the drawing layer's alpha channel (nonzero →
  255; an empty drawing animates everything);
- the resolution snaps to /8, keeping the validation area;
- the motion strength is the slider times the mask's mean;
- sampling starts from DDPM-forward noised image latents, seeded by the
  request's seed (the sample index where the seed is -1).

The models run in ``mixed_precision`` (bf16 by default, the kernels' dtype;
JAX's controller builds them in fp32), on ``device``.

    python -m animate_anything_tpu_torch.app --config configs/train_mask_motion.yaml \\
        --image in.png --mask mask.png --prompt "a girl moves" --out out.gif
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch


class AnimateController:
    def __init__(self, pretrained_model_path=None, validation_data=None, output_dir="output/app",
                 model_size="full", attn_impl=None, mixed_precision="bf16", device="cuda"):
        from animate_anything_tpu_torch.core.config import Config
        from animate_anything_tpu_torch.core.dtypes import policy_from_string
        from animate_anything_tpu_torch.models.factory import build_models, resolve_device
        from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

        self.device = resolve_device(device)
        self.validation_data = Config(validation_data or {})
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        models = build_models(
            pretrained_model_path, motion_mask=True, motion_strength=True,
            model_size=model_size, attn_impl=attn_impl, device=self.device,
            compute_dtype=policy_from_string(mixed_precision).compute_dtype,
        )
        self.pipeline = LatentToVideoPipeline(
            models["unet"], models["vae"], text_encoder=models["text"],
            tokenizer=models["tokenizer"], schedule=models["schedule"])
        self.sample_idx = 0

    def animate(self, init_img, motion_scale=3.0, prompt="", negative_prompt="",
                sample_steps=25, cfg_scale=9.0, seed=-1):
        """init_img: (h, w, 3) uint8, or {background, layers} in the gradio
        sketch format (the mask is layers[0]'s alpha). → the gif's path."""
        from PIL import Image

        from animate_anything_tpu_torch.utils import media

        if isinstance(init_img, dict):
            image = np.asarray(init_img["background"])[..., :3]
            np_mask = np.asarray(init_img["layers"][0])[..., 3].copy()
            np_mask[np_mask != 0] = 255
            if np_mask.sum() == 0:
                np_mask[:] = 255
        else:
            image = np.asarray(init_img)[..., :3]
            np_mask = np.full(image.shape[:2], 255, np.uint8)

        vd = self.validation_data
        h0, w0 = image.shape[:2]
        scale = math.sqrt(h0 * w0 / (int(vd.get("height", 512)) * int(vd.get("width", 512))))
        h = round(h0 / scale / 8) * 8
        w = round(w0 / scale / 8) * 8
        image = np.array(Image.fromarray(image).resize((w, h), Image.LANCZOS))
        np_mask = np.array(Image.fromarray(np_mask).resize((w, h), Image.NEAREST))

        motion_strength = float(motion_scale) * float((np_mask / 255.0).mean())
        gen = torch.Generator(self.device).manual_seed(
            int(seed) if seed not in (-1, "", "-1") else self.sample_idx)
        video, _ = self.pipeline.animate_image(
            image, prompt, mask_img=np_mask, motion_strength=motion_strength,
            num_frames=int(vd.get("num_frames", 16)),
            num_inference_steps=int(sample_steps), guidance_scale=float(cfg_scale),
            generator=gen)
        path = os.path.join(self.output_dir, f"{self.sample_idx}.gif")
        media.save_gif(path, media.to_uint8(video[0].float().cpu().numpy()), fps=8)
        self.sample_idx += 1
        return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--image", type=str, required=True)
    ap.add_argument("--mask", type=str, default=None)
    ap.add_argument("--prompt", type=str, default="")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--cfg", type=float, default=9.0)
    ap.add_argument("--motion", type=float, default=3.0)
    ap.add_argument("--device", type=str, default="cuda")
    args, unknown = ap.parse_known_args(argv)

    from animate_anything_tpu_torch.utils import media

    cfg = {}
    if args.config:
        from animate_anything_tpu_torch.core.config import load_config

        cfg = load_config(args.config, [u for u in unknown if "=" in u]).to_dict()
    controller = AnimateController(
        cfg.get("pretrained_model_path"), cfg.get("validation_data"),
        output_dir=cfg.get("output_dir", "output/app"),
        model_size=cfg.get("model_size", "full"), attn_impl=cfg.get("attn_impl"),
        mixed_precision=cfg.get("mixed_precision", "bf16"), device=args.device)
    image = media.load_image(args.image)
    if args.mask:
        layers = np.zeros(image.shape[:2] + (4,), np.uint8)
        layers[..., 3] = np.asarray(media.load_image(args.mask))[..., 0]
        init = {"background": image, "layers": [layers]}
    else:
        init = image
    path = controller.animate(init, args.motion, args.prompt, sample_steps=args.steps,
                              cfg_scale=args.cfg)
    if args.out:
        os.replace(path, args.out)
        path = args.out
    print(path)


if __name__ == "__main__":
    main()
