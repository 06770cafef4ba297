"""The training and eval entry points — the port of
``animate_anything_tpu/cli.py`` (``train.py`` / ``train_lora.py``):

    python -m animate_anything_tpu_torch.cli --config configs/train_mask_motion.yaml \
        [--eval] [key.subkey=value ...] [--device cpu]

``main(**cfg)`` trains: the run directory ``{output_dir}/{time}`` with
``config.yaml`` and ``train_log.jsonl``; the datasets (``extra_train_data``,
``extend_dataset``, a latent cache); the full finetune or UNet and/or text
LoRA; resume from ``ckpt/``; checkpoints every ``checkpointing_steps`` and
at the end, with the adapter files or the pipeline directory; the
validation preview at ``validation_steps`` and at step 5. ``main_eval(**cfg)``
builds the models (``models/factory.build_models``: a diffusers-layout
directory, or random weights when ``pretrained_model_path`` is not a
directory), merges a saved adapter (``lora_path`` and its text-encoder
sibling), animates the validation image ``eval_iters`` times and reports
the motion metrics. Both run on the card unless ``device="cpu"`` is passed.
PAB step caching is not ported and raises.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import time
from typing import Any, Optional

import numpy as np
import torch

from animate_anything_tpu_torch.core.config import Config, load_config
from animate_anything_tpu_torch.core.dtypes import cast_module_, policy_from_string
from animate_anything_tpu_torch.data import (ConcatDataset, DataLoader, device_prefetch,
                                             extend_datasets, get_train_dataset)
from animate_anything_tpu_torch.data.loader import check_mesh
from animate_anything_tpu_torch.metrics.motion import (calculate_motion_precision,
                                                       latent_motion_score)
from animate_anything_tpu_torch.models.factory import build_models, resolve_device
from animate_anything_tpu_torch.models.lora import (LoraConfig, collapse_lora_, init_lora_params,
                                                    load_lora, lora_params, merged_weights,
                                                    save_lora, substituted)
from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
from animate_anything_tpu_torch.train import (TrainConfig, create_lora_train_state,
                                              create_train_state, make_lora_train_step,
                                              make_train_step)
from animate_anything_tpu_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                                         save_checkpoint, save_pipeline)
from animate_anything_tpu_torch.train.trainer import batch_latents
from animate_anything_tpu_torch.utils import media
from animate_anything_tpu_torch.utils.logging_util import MetricLogger


def _build_pipeline(models, sampler: str = "dpmpp", pab=None) -> LatentToVideoPipeline:
    return LatentToVideoPipeline(models["unet"], models["vae"], text_encoder=models["text"],
                                 tokenizer=models["tokenizer"], schedule=models["schedule"],
                                 sampler=sampler, pab=pab)


def run_validation(models, validation_data: Config, output_dir: str, step: int,
                   motion_mask: bool, motion_strength: bool,
                   generator: Optional[torch.Generator] = None, eval_index: int = 0,
                   sampler: str = "dpmpp", noise: Optional[torch.Tensor] = None,
                   pab: Optional[dict] = None) -> dict:
    """Animate the validation image, write the sample, report the motion
    metrics (the sample a gif with an mp4 sidecar, the mask a jpg).
    ``noise`` (the start latents' noise) overrides ``generator``; ``pab``:
    the PAB step-caching config, or None."""
    pipe = _build_pipeline(models, sampler, pab)
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


def _cast(models: dict, policy) -> dict:
    """The modules cast to the policy (bf16 matrices) unless it is fp32."""
    if policy.compute_dtype != torch.float32:
        for name in ("unet", "vae", "text"):
            cast_module_(models[name])
    return models


def eval_models(cfg: Config, device="cuda") -> dict:
    """The models ``main_eval`` runs for ``cfg``: built in fp32, as JAX's
    parameters are; a saved adapter merged in (``lora_path``, and the text
    encoder's from ``lora_text_path`` or the ``.text_encoder.safetensors``
    file beside ``lora_path``); then cast to the policy. The schedule is
    unrescaled, as JAX's ``main_eval`` builds it."""
    models = build_models(
        cfg.get("pretrained_model_path"),
        motion_mask=bool(cfg.get("motion_mask", False)),
        motion_strength=bool(cfg.get("motion_strength", False)),
        model_size=cfg.get("model_size", "full"),
        compute_dtype=torch.float32,
        attn_impl=cfg.get("attn_impl"),
        device=device,
    )
    lora_path = cfg.get("lora_path")
    if lora_path:
        tree, lcfg = load_lora(lora_path, device=device)
        collapse_lora_(models["unet"], tree, lcfg)
    text_lora_path = cfg.get("lora_text_path")
    if not text_lora_path and lora_path:
        cand = os.path.splitext(lora_path)[0] + ".text_encoder.safetensors"
        text_lora_path = cand if os.path.exists(cand) else None
    if text_lora_path:
        tree, lcfg = load_lora(text_lora_path, prefix="text_encoder", device=device)
        collapse_lora_(models["text"], tree, lcfg, naming="text")
    return _cast(models, policy_from_string(cfg.get("mixed_precision", "bf16")))


def main_eval(*, device="cuda", **cfg_kw) -> dict:
    """Batch eval: ``eval_iters`` validation samples (iteration i seeded i,
    strength i + 3), each printed; returns the last one's metrics, with the
    mean motion precision where there is a mask."""
    cfg = Config(cfg_kw)
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
            eval_index=i, pab=(dict(cfg.pab) if cfg.get("pab") else None))
        print(metrics)
        if "motion_precision" in metrics:
            precisions.append(metrics["motion_precision"])
        out = metrics
    if precisions:
        out["mean_motion_precision"] = float(np.mean(precisions))
        print(f"mean motion precision: {out['mean_motion_precision']:.4f}")
    return out


def train_dataset(cfg: Config, tokenizer):
    """The YAML's datasets: ``dataset_types`` over ``train_data``, each
    ``extra_train_data`` entry's, balanced by ``extend_dataset``; one
    dataset, or their concatenation."""
    datasets = get_train_dataset(list(cfg.get("dataset_types", ["folder"])),
                                 dict(cfg.get("train_data", {})), tokenizer)
    for extra in cfg.get("extra_train_data", []) or []:
        datasets += get_train_dataset(list(extra.get("dataset_types", [])),
                                      dict(extra.get("train_data", {})), tokenizer)
    datasets = extend_datasets(datasets, extend=bool(cfg.get("extend_dataset", False)))
    return ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]


@torch.no_grad()
def cache_dataset(dataset, vae, cache_dir: str, device):
    """Encode every item's clip once with the frozen VAE into ``cache_dir``
    (JAX's ``cache_latents``) → the ``CachedDataset`` over it."""
    from animate_anything_tpu_torch.data import CachedDataset

    for i in range(len(dataset)):
        item = dataset[i]
        pixels = torch.from_numpy(np.asarray(item["pixel_values"]))[None].to(device)
        latents = batch_latents({"pixel_values": pixels}, vae)[0].cpu().numpy()
        CachedDataset.save_item(cache_dir, i, {"latents": latents, "mask": item["mask"],
                                               "prompt_ids": item["prompt_ids"]})
    return CachedDataset(cache_dir=cache_dir)


def train_config(cfg: Config) -> TrainConfig:
    """The YAML's trainer settings, with JAX's ``main``'s defaults."""
    return TrainConfig(
        learning_rate=float(cfg.get("learning_rate", 5e-6)),
        adam_weight_decay=float(cfg.get("adam_weight_decay", 1e-2)),
        use_8bit_adam=bool(cfg.get("use_8bit_adam", False)),
        max_grad_norm=float(cfg.get("max_grad_norm", 1.0)),
        gradient_accumulation_steps=int(cfg.get("gradient_accumulation_steps", 1)),
        trainable_modules=tuple(cfg.get("trainable_modules", ["all"])),
        not_trainable_modules=tuple(cfg.get("not_trainable_modules", [])),
        motion_mask=bool(cfg.get("motion_mask", False)),
        motion_strength=bool(cfg.get("motion_strength", False)),
        use_offset_noise=bool(cfg.get("use_offset_noise", False)),
        offset_noise_strength=float(cfg.get("offset_noise_strength", 0.1)),
        rescale_schedule=bool(cfg.get("rescale_schedule", False)),
        cache_latents=bool(cfg.get("cache_latents", False)),
    )


def lora_configs(cfg: Config) -> tuple:
    """(UNet LoRA config or None, text LoRA config or None), JAX's defaults."""
    unet = text = None
    if bool(cfg.get("use_unet_lora", False)):
        unet = LoraConfig(rank=int(cfg.get("lora_rank", 16)),
                          targets=tuple(cfg.get("unet_lora_modules", ["UNet3DConditionModel"])),
                          include_convs=bool(cfg.get("lora_include_convs", False)),
                          dropout=float(cfg.get("lora_unet_dropout", 0.0)))
    if bool(cfg.get("use_text_lora", False)):
        text = LoraConfig(rank=int(cfg.get("lora_rank", 16)),
                          targets=tuple(cfg.get("text_encoder_lora_modules",
                                                ["CLIPEncoderLayer"])),
                          dropout=float(cfg.get("lora_text_dropout", 0.0)))
    return unet, text


@contextlib.contextmanager
def _lora_merged(models: dict, state, bases: dict, lora_cfg, text_lora_cfg):
    """The adapters merged into the UNet and text encoder for a preview."""
    with torch.no_grad(), contextlib.ExitStack() as stack:
        if lora_cfg is not None:
            stack.enter_context(substituted(models["unet"], merged_weights(
                models["unet"], bases["unet"], state.params["unet_lora"], lora_cfg)))
        if text_lora_cfg is not None:
            stack.enter_context(substituted(models["text"], merged_weights(
                models["text"], bases["text"], state.params["text_lora"], text_lora_cfg,
                naming="text")))
        yield


def main(*, device="cuda", **cfg_kw) -> str:
    """Train as JAX's ``main`` does; → the run directory. Full finetune: the
    fp32 masters of the trainable UNet parameters and AdamW (or the 8-bit
    AdamW) on the card, the modules in the policy's dtypes; the pipeline is
    written from the masters and host fp32 copies of every other weight, as
    JAX writes its fp32 parameters unchanged. LoRA
    (``use_unet_lora`` / ``use_text_lora``): the adapters seeded ``seed + 7``
    and ``seed + 8``, fp32 copies of the adapted kernels as the merge's
    base, the modules frozen. The noise, t and dropout draws come from one
    generator seeded ``seed`` (also on resume, as JAX restarts its key)."""
    cfg = Config(cfg_kw)
    dev = resolve_device(device)
    check_mesh(cfg.get("mesh"))
    run_dir = os.path.join(cfg.get("output_dir", "./output"), time.strftime("%Y-%m-%dT%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    Config(cfg).save(os.path.join(run_dir, "config.yaml"))
    logger = MetricLogger(run_dir)

    seed = int(cfg.get("seed") or 0)
    random.seed(seed)
    np.random.seed(seed)
    generator = torch.Generator(dev).manual_seed(seed)
    policy = policy_from_string(cfg.get("mixed_precision", "bf16"))
    motion_mask = bool(cfg.get("motion_mask", False))
    motion_strength = bool(cfg.get("motion_strength", False))
    models = build_models(
        cfg.get("pretrained_model_path"), motion_mask=motion_mask,
        motion_strength=motion_strength, model_size=cfg.get("model_size", "full"),
        compute_dtype=torch.float32, rescale_schedule=bool(cfg.get("rescale_schedule", False)),
        attn_impl=cfg.get("attn_impl"),
        gradient_checkpointing=bool(cfg.get("gradient_checkpointing", False)),
        seed=seed, device=dev)
    unet, vae, text = models["unet"], models["vae"], models["text"]

    # the trained tensors, from the fp32 weights before the policy's cast
    tconf = train_config(cfg)
    lora_cfg, text_lora_cfg = lora_configs(cfg)
    use_lora = lora_cfg is not None or text_lora_cfg is not None
    bases = {}
    for module in (unet, vae, text):
        module.requires_grad_(False)
    if use_lora:
        tree = {}
        if lora_cfg is not None:
            params = lora_params(unet)
            tree["unet_lora"] = init_lora_params(torch.Generator(dev).manual_seed(seed + 7),
                                                 params, lora_cfg)
            bases["unet"] = {p: params[p].detach().clone() for p in tree["unet_lora"]}
        if text_lora_cfg is not None:
            params = lora_params(text, "text")
            tree["text_lora"] = init_lora_params(torch.Generator(dev).manual_seed(seed + 8),
                                                 params, text_lora_cfg)
            bases["text"] = {p: params[p].detach().clone() for p in tree["text_lora"]}
        state = create_lora_train_state(tree, tconf)
    else:
        state = create_train_state(unet, tconf)
    save_pretrained = not use_lora and bool(cfg.get("save_pretrained_model", True))
    fp32 = {}
    if save_pretrained:      # what the cast rounds and the masters do not hold
        fp32 = {name: {n: p.detach().to("cpu", copy=True) for n, p in m.named_parameters()
                       if n not in (state.masters if name == "unet" else ())}
                for name, m in (("unet", unet), ("vae", vae), ("text", text))}
    _cast(models, policy)

    dataset = train_dataset(cfg, models["tokenizer"])
    if cfg.get("cached_latent_dir"):
        from animate_anything_tpu_torch.data import CachedDataset

        dataset = CachedDataset(cache_dir=cfg.cached_latent_dir)
    elif tconf.cache_latents:
        cache_dir = os.path.join(run_dir, "cached_latents")
        dataset = cache_dataset(dataset, vae, cache_dir, dev)
        print(f"cached {len(dataset)} latent items → {cache_dir}")
    loader = DataLoader(dataset, batch_size=int(cfg.get("train_batch_size", 1)), shuffle=True,
                        seed=seed)

    resume = cfg.get("resume_from_checkpoint")
    if resume:
        path = (resume if os.path.basename(resume).startswith("step_")
                else latest_checkpoint(resume))
        if path:
            restore_checkpoint(path, state)
            print(f"resumed from {path} at step {state.step}")

    if use_lora:
        step_fn = make_lora_train_step(
            models["schedule"], tconf, unet, bases.get("unet"), lora_cfg, text_encoder=text,
            text_base=bases.get("text"), text_lora_config=text_lora_cfg, vae=vae, device=dev)
    else:
        step_fn = make_train_step(models["schedule"], tconf, vae=vae, text_encoder=text,
                                  device=dev)
    uncond_ids = torch.as_tensor(np.asarray(models["tokenizer"](
        "", padding="max_length", max_length=77).input_ids), device=dev)

    max_steps = int(cfg.get("max_train_steps", 100))
    ckpt_steps = int(cfg.get("checkpointing_steps", max_steps))
    val_steps = int(cfg.get("validation_steps", max_steps * 10))
    sample_preview = bool(cfg.get("validation_data", {}).get("sample_preview", False))
    global_step = state.step
    while global_step < max_steps:
        for batch in device_prefetch(iter(loader), device=dev, mesh=cfg.get("mesh")):
            if global_step >= max_steps:
                break
            for key in ("text_prompt", "dataset", "motion"):
                batch.pop(key, None)
            batch["uncond_ids"] = uncond_ids.expand(batch["prompt_ids"].shape[0], -1)
            metrics = step_fn(state, batch, generator)
            global_step = state.step
            logger.log(global_step, metrics,
                       echo=global_step % int(cfg.get("log_every", 10)) == 0)

            if global_step % ckpt_steps == 0 or global_step >= max_steps:
                save_checkpoint(os.path.join(run_dir, "ckpt"), state)
                if lora_cfg is not None:
                    save_lora(os.path.join(run_dir, f"lora_step_{global_step}.safetensors"),
                              state.params["unet_lora"], lora_cfg)
                if text_lora_cfg is not None:
                    save_lora(os.path.join(
                        run_dir, f"lora_step_{global_step}.text_encoder.safetensors"),
                        state.params["text_lora"], text_lora_cfg, prefix="text_encoder")
                if save_pretrained:
                    with substituted(unet, {**fp32["unet"], **state.masters}), \
                            substituted(vae, fp32["vae"]), substituted(text, fp32["text"]):
                        save_pipeline(os.path.join(run_dir, f"pipeline_step_{global_step}"),
                                      unet, models["unet_config"], vae, models["vae_config"],
                                      text, models["text_config"])
            if sample_preview and (global_step % val_steps == 0 or global_step == 5):
                with (_lora_merged(models, state, bases, lora_cfg, text_lora_cfg) if use_lora
                      else contextlib.nullcontext()):
                    vm = run_validation(models, cfg.validation_data, run_dir, global_step,
                                        motion_mask, motion_strength)
                logger.log(global_step, {k: v for k, v in vm.items()
                                         if isinstance(v, (int, float))})
    logger.close()
    return run_dir


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides=[u for u in unknown if "=" in u])
    if args.eval:
        main_eval(device=args.device, **cfg.to_dict())
    else:
        main(device=args.device, **cfg.to_dict())


if __name__ == "__main__":
    cli()
