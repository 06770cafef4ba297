"""The SVD eval entry point — the port of ``animate_anything_tpu/cli_svd.py``
(``train_svd.py --eval``):

    python -m animate_anything_tpu_torch.cli_svd --config configs/train_svd_mask.yaml \
        --eval [key.subkey=value ...] [--device cpu]

``main_eval(**cfg)`` builds the SVD UNet, the VAE and the CLIP vision tower
with random weights from ``seed`` (JAX's ``build_svd_models`` always draws
them: the SVD weight import waits for weights in the repository), then
animates the validation image, or each image of ``eval_file`` ``iters``
times, through ``MaskStableVideoDiffusionPipeline`` and writes the gifs. A
missing image is replaced by a seeded random one, a missing ``_label.jpg``
mask by all ones, as in JAX. It runs on the card unless ``device="cpu"`` is
passed. Training (``cli_svd.main``) is the next slice of the port.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from animate_anything_tpu_torch.core.config import Config, load_config
from animate_anything_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_module_, policy_from_string
from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                           CLIPVisionModelWithProjection)
from animate_anything_tpu_torch.models.factory import resolve_device
from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                        UNetSpatioTemporalConditionModel)
from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from animate_anything_tpu_torch.pipelines.svd import MaskStableVideoDiffusionPipeline
from animate_anything_tpu_torch.utils import media
from animate_anything_tpu_torch.utils.convert import (init_clip_vision_, init_svd_unet_,
                                                      init_vae_)


def build_svd_models(motion_mask: bool = False, model_size: str = "full",
                     compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                     attn_impl: Optional[str] = None, device="cuda") -> dict:
    """→ dict(unet, unet_config, vae, vae_config, image_encoder,
    image_config), on ``device`` in eval mode, the weights drawn as the flax
    initialisers do from generators seeded ``seed``, ``seed + 1`` and
    ``seed + 2``; bf16 ``compute_dtype`` casts them to the half policy."""
    dev = resolve_device(device)
    if compute_dtype not in (torch.float32, COMPUTE_DTYPE):
        raise ValueError(f"compute_dtype must be float32 or {COMPUTE_DTYPE}, got {compute_dtype}")
    ukw = dict(in_channels=9 if motion_mask else 8, attn_impl=attn_impl)
    if model_size == "tiny":
        ucfg = SVDUNetConfig.tiny(**ukw)
        vcfg = VAEConfig.tiny()
        icfg = CLIPVisionConfig.tiny(projection_dim=ucfg.cross_attention_dim)
    else:
        ucfg, vcfg, icfg = SVDUNetConfig(**ukw), VAEConfig(), CLIPVisionConfig()
    with dev:
        unet = UNetSpatioTemporalConditionModel(ucfg)
        vae = AutoencoderKL(vcfg)
        ienc = CLIPVisionModelWithProjection(icfg)
    for i, (module, init) in enumerate(((unet, init_svd_unet_), (vae, init_vae_),
                                        (ienc, init_clip_vision_))):
        init(module, torch.Generator(device=dev).manual_seed(seed + i))
        if compute_dtype != torch.float32:
            cast_module_(module)
        module.eval()
    return dict(unet=unet, unet_config=ucfg, vae=vae, vae_config=vcfg, image_encoder=ienc,
                image_config=icfg)


def _mask(img_path: Optional[str], image: np.ndarray, out_stem: Optional[str],
          device) -> torch.Tensor:
    """The motion mask at the latents' size: the ``<image>_label.jpg``
    sidecar binarised (and written beside the sample), else all ones."""
    from PIL import Image

    lh, lw = image.shape[0] // 8, image.shape[1] // 8
    label_path = os.path.splitext(img_path)[0] + "_label.jpg" if img_path else ""
    if not (label_path and os.path.exists(label_path)):
        return torch.ones((1, 1, lh, lw, 1), device=device)
    np_mask = (media.load_image(label_path)[..., 0] != 0).astype(np.float32)
    if out_stem:
        media.save_image(out_stem + "_mask.jpg", (np_mask * 255).astype(np.uint8))
    m = Image.fromarray((np_mask * 255).astype(np.uint8))
    np_mask = np.asarray(m.resize((lw, lh), Image.NEAREST)) / 255.0
    return torch.as_tensor(np_mask, dtype=torch.float32, device=device)[None, None, :, :, None]


def main_eval(*, device="cuda", **cfg_kw) -> dict:
    """→ {"sample_path": the last gif, "sample_paths": every gif}."""
    cfg = Config(cfg_kw)
    dev = resolve_device(device)
    out_dir = cfg.get("output_dir", "./output")
    os.makedirs(out_dir, exist_ok=True)
    policy = policy_from_string(cfg.get("mixed_precision", "bf16"))
    motion_mask = bool(cfg.get("motion_mask", False))
    models = build_svd_models(motion_mask=motion_mask, model_size=cfg.get("model_size", "full"),
                              compute_dtype=policy.compute_dtype, attn_impl=cfg.get("attn_impl"),
                              device=dev)
    pipe = MaskStableVideoDiffusionPipeline(models["unet"], models["vae"],
                                            image_encoder=models["image_encoder"])
    vd = cfg.get("validation_data", Config())
    h, w = int(vd.get("height", 512)), int(vd.get("width", 512))
    num_frames = int(vd.get("num_frames", 14))

    # eval_file: a JSON list of [image, prompt] pairs, ``iters`` samples each
    eval_file = cfg.get("eval_file")
    if eval_file:
        with open(eval_file) as f:
            eval_list = json.load(f)
        iters = int(cfg.get("iters", 5))
    else:
        eval_list = [[vd.get("prompt_image"), vd.get("prompt", "")]]
        iters = 1

    def sample_one(img_path, seed, out_stem=None):
        if img_path and os.path.exists(img_path):
            # the image's native aspect rescaled to the validation area, /64
            image = media.fit_image_to_area(img_path, h, w, multiple=64)
        else:
            image = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
        mask = _mask(img_path, image, out_stem, dev) if motion_mask else None
        video, _ = pipe(image, mask=mask, num_frames=num_frames,
                        num_inference_steps=int(vd.get("num_inference_steps", 25)),
                        decode_chunk_size=int(vd.get("decode_chunk_size", 0)) or None,
                        fps=int(vd.get("fps", 7)),
                        motion_bucket_id=int(vd.get("motion_bucket_id", 127)),
                        generator=torch.Generator(dev).manual_seed(seed))
        return media.to_uint8(video[0].float().cpu().numpy())

    base_seed = int(cfg.get("seed") or 0)
    paths = []
    for name, _prompt in eval_list:
        stem = os.path.splitext(os.path.basename(name))[0] if name else "svd_sample"
        sub = os.path.join(out_dir, stem) if eval_file else out_dir
        os.makedirs(sub, exist_ok=True)
        for t in range(iters):
            out_path = os.path.join(sub, f"{t}.gif" if eval_file else "svd_sample.gif")
            frames = sample_one(name, base_seed + t, out_stem=os.path.splitext(out_path)[0])
            path = media.save_gif(out_path, frames, fps=int(vd.get("fps", 7)))
            print("save file", path)
            paths.append(path)
    print({"sample_path": paths[-1]})
    return {"sample_path": paths[-1], "sample_paths": paths}


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides=[u for u in unknown if "=" in u])
    if not args.eval:
        raise NotImplementedError("SVD training (cli_svd.main, train/svd_trainer.py) is not "
                                  "ported yet: it is the next slice of the port (ROADMAP queue "
                                  "C); pass --eval")
    main_eval(device=args.device, **cfg.to_dict())


if __name__ == "__main__":
    cli()
