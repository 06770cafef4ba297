"""The SVD entry points — the port of ``animate_anything_tpu/cli_svd.py``
(``train_svd.py``):

    python -m animate_anything_tpu_torch.cli_svd --config configs/train_svd_mask.yaml \
        [--eval] [key.subkey=value ...] [--device cpu]

``main(**cfg)`` trains the SVD UNet as JAX's ``main`` does: the models with
``gradient_checkpointing``, the datasets (``extra_train_data``,
``extend_dataset``) and the loader, the host-side CLIP preprocessing of each
sample's frame 0, the EDM step of ``train/svd_trainer.py`` on fp32 masters,
and every ``checkpointing_steps`` steps and at the end the train state
(``train/checkpoint.save_checkpoint``) and the UNet in the diffusers layout
(``_save_svd_pipeline``). The config's ``mesh`` is read as JAX reads it
(``data`` 1 by default): under ``torchrun`` with ``mesh.data`` -1 or the
process count, each process drives one GPU on its rows of every global
batch, the gradients are averaged and the optimizer state split over the
data axis, and rank 0 logs and writes.

``main_eval(**cfg)`` builds the SVD UNet, the VAE and the CLIP vision tower
with random weights from ``seed`` (JAX's ``build_svd_models`` always draws
them: the SVD weight import waits for weights in the repository), then
animates the validation image, or each image of ``eval_file`` ``iters``
times, through ``MaskStableVideoDiffusionPipeline`` and writes the gifs. A
missing image is replaced by a seeded random one, a missing ``_label.jpg``
mask by all ones, as in JAX. Both run on the card unless ``device="cpu"`` is
passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from animate_anything_tpu_torch.core.config import Config, load_config
from animate_anything_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_module_, policy_from_string
from animate_anything_tpu_torch.core.mesh import (broadcast_object, init_distributed,
                                                  is_main_process)
from animate_anything_tpu_torch.data import DataLoader, device_prefetch
from animate_anything_tpu_torch.data.loader import check_mesh
from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                           CLIPVisionModelWithProjection,
                                                           preprocess_clip_image)
from animate_anything_tpu_torch.models.factory import resolve_device
from animate_anything_tpu_torch.models.lora import substituted
from animate_anything_tpu_torch.parallel.tensor import full_weights, mesh_group, shard_model
from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                        UNetSpatioTemporalConditionModel)
from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from animate_anything_tpu_torch.pipelines.svd import MaskStableVideoDiffusionPipeline
from animate_anything_tpu_torch.train import create_train_state
from animate_anything_tpu_torch.train.checkpoint import save_checkpoint, save_component
from animate_anything_tpu_torch.train.svd_trainer import SVDTrainConfig, make_svd_train_step
from animate_anything_tpu_torch.utils import media
from animate_anything_tpu_torch.utils.convert import (init_clip_vision_, init_svd_unet_,
                                                      init_vae_, svd_flax_path)
from animate_anything_tpu_torch.utils.logging_util import run_logger


def build_svd_models(motion_mask: bool = False, model_size: str = "full",
                     compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                     attn_impl: Optional[str] = None, gradient_checkpointing: bool = False,
                     device="cuda") -> dict:
    """→ dict(unet, unet_config, vae, vae_config, image_encoder,
    image_config), on ``device`` in eval mode, the weights drawn as the flax
    initialisers do from generators seeded ``seed``, ``seed + 1`` and
    ``seed + 2``; bf16 ``compute_dtype`` casts them to the half policy;
    ``gradient_checkpointing`` recomputes the UNet's blocks in the backward."""
    dev = resolve_device(device)
    if compute_dtype not in (torch.float32, COMPUTE_DTYPE):
        raise ValueError(f"compute_dtype must be float32 or {COMPUTE_DTYPE}, got {compute_dtype}")
    ukw = dict(in_channels=9 if motion_mask else 8, attn_impl=attn_impl,
               gradient_checkpointing=gradient_checkpointing)
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


def main(*, device="cuda", **cfg_kw) -> str:
    """Train as JAX's ``main`` does; → the run directory
    ``{output_dir}/svd_{time}`` (``config.yaml``, ``train_log.jsonl``,
    ``ckpt/``, ``pipeline_step_N/unet/``). The fp32 masters of the trainable
    UNet parameters and AdamW on the card, the modules in the policy's
    dtypes; the draws from one generator seeded ``seed``."""
    from animate_anything_tpu_torch.cli import train_dataset

    cfg = Config(cfg_kw)
    dev = resolve_device(device)
    init_distributed(dev)
    mesh = check_mesh(cfg.get("mesh"), default_data=1)
    main_rank = is_main_process()
    run_dir = broadcast_object(os.path.join(cfg.get("output_dir", "./output"),
                                            time.strftime("svd_%Y-%m-%dT%H-%M-%S")))
    if main_rank:
        os.makedirs(run_dir, exist_ok=True)
        Config(cfg).save(os.path.join(run_dir, "config.yaml"))
    logger = run_logger(run_dir)
    seed = int(cfg.get("seed") or 0)
    generator = torch.Generator(dev).manual_seed(seed)
    policy = policy_from_string(cfg.get("mixed_precision", "bf16"))
    motion_mask = bool(cfg.get("motion_mask", False))

    models = build_svd_models(
        motion_mask=motion_mask, model_size=cfg.get("model_size", "full"),
        compute_dtype=torch.float32, seed=seed, attn_impl=cfg.get("attn_impl"),
        gradient_checkpointing=bool(cfg.get("gradient_checkpointing", False)), device=dev)
    unet = models["unet"]
    tconf = SVDTrainConfig(
        learning_rate=float(cfg.get("learning_rate", 5e-6)),
        adam_weight_decay=float(cfg.get("adam_weight_decay", 1e-2)),
        gradient_accumulation_steps=int(cfg.get("gradient_accumulation_steps", 1)),
        trainable_modules=tuple(cfg.get("trainable_modules", ["all"])),
        motion_mask=motion_mask)
    for name in ("unet", "vae", "image_encoder"):
        models[name].requires_grad_(False)
    tp = mesh_group(mesh)           # the tensor axis slices the UNet's attention and FF weights
    if tp is not None:
        shard_model(unet, mesh)
    state = create_train_state(unet, tconf, svd_flax_path, mesh)
    save_pretrained = bool(cfg.get("save_pretrained_model", True))
    # what the cast rounds and the masters do not hold (every tensor rank's slices)
    fp32 = ({n: p.detach().to("cpu", copy=True) for n, p in unet.named_parameters()
             if n not in state.masters} if save_pretrained and (main_rank or tp is not None)
            else {})
    if policy.compute_dtype != torch.float32:
        for name in ("unet", "vae", "image_encoder"):
            cast_module_(models[name])

    loader = DataLoader(train_dataset(cfg, None),
                        batch_size=int(cfg.get("train_batch_size", 1)), shuffle=True, seed=seed,
                        mesh=mesh)
    step_fn = make_svd_train_step(tconf, models["vae"], models["image_encoder"], device=dev,
                                  mesh=mesh)
    size = models["image_config"].image_size
    max_steps = int(cfg.get("max_train_steps", 100))
    ckpt_steps = int(cfg.get("checkpointing_steps", max_steps))
    global_step = state.step
    while global_step < max_steps:
        for batch in device_prefetch(iter(loader), device=dev, mesh=mesh):
            if global_step >= max_steps:
                break
            pixels = batch["pixel_values"]
            # the image encoder's input: each sample's frame 0, on the host
            frames = pixels[:, 0].float().cpu().numpy()
            clip_px = np.concatenate([preprocess_clip_image(media.to_uint8(fr), size)
                                      for fr in frames])
            step_batch = {"pixel_values": pixels, "mask": batch["mask"].float(),
                          "clip_pixel_values": torch.as_tensor(clip_px, device=dev)}
            metrics = step_fn(state, step_batch, generator)
            global_step = state.step
            logger.log(global_step, metrics,
                       echo=global_step % int(cfg.get("log_every", 10)) == 0)
            if global_step % ckpt_steps == 0 or global_step >= max_steps:
                save_checkpoint(os.path.join(run_dir, "ckpt"), state)
                unet_w = full_weights(unet, {**fp32, **state.masters}) if save_pretrained else None
                if save_pretrained and main_rank:
                    with substituted(unet, unet_w):
                        _save_svd_pipeline(os.path.join(run_dir, f"pipeline_step_{global_step}"),
                                           unet, models["unet_config"])
    logger.close()
    return run_dir


def _save_svd_pipeline(out_dir: str, unet: torch.nn.Module, unet_config: SVDUNetConfig) -> str:
    """The UNet in the diffusers layout, as JAX's ``_save_svd_pipeline``:
    ``unet/config.json`` (the config with ``_class_name``) and
    ``unet/diffusion_pytorch_model.safetensors`` in fp32 under diffusers
    keys (the port's names); → ``out_dir``."""
    cfg = dataclasses.asdict(unet_config)
    cfg["_class_name"] = "UNetSpatioTemporalConditionModel"
    save_component(out_dir, "unet", "diffusion_pytorch_model.safetensors", unet, cfg)
    return out_dir


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
    (main_eval if args.eval else main)(device=args.device, **cfg.to_dict())


if __name__ == "__main__":
    cli()
