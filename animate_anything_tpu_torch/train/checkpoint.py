"""Diffusers-layout pipeline directories — the port of the pipeline half of
``animate_anything_tpu/train/checkpoint.py``.

A directory holds ``unet/``, ``vae/`` and ``text_encoder/``, each with a
``config.json`` (the config dataclass as a dict) and its weights in fp32
safetensors under diffusers / HF key names, and ``model_index.json``;
``scheduler/scheduler_config.json`` is read where present. The JAX package
writes and reads the same layout, so a directory written by either side
loads into the other. The train-state resume (orbax in JAX) is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
from safetensors.torch import save_file

from animate_anything_tpu_torch.utils.convert import load_state_dict


def _save_component(out_dir: str, sub: str, weights: str, module: torch.nn.Module,
                    config: dict) -> int:
    """Write ``module``'s config and its weights as fp32 (the whole state
    dict copied to the host first); → the weight file's bytes."""
    os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    with open(os.path.join(out_dir, sub, "config.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)
    path = os.path.join(out_dir, sub, weights)
    save_file({k: v.detach().to("cpu", torch.float32).contiguous()
               for k, v in module.state_dict().items()}, path)
    return os.path.getsize(path)


def save_pipeline(out_dir: str, unet: torch.nn.Module, unet_config,
                  vae: Optional[torch.nn.Module] = None, vae_config=None,
                  text_encoder: Optional[torch.nn.Module] = None, text_config=None) -> int:
    """Write the modules' weights (fp32, whatever dtype they run in) and
    configs under ``out_dir``; returns the weight bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    ucfg = dataclasses.asdict(unet_config)
    ucfg["_class_name"] = "UNet3DConditionModel"
    total = _save_component(out_dir, "unet", "diffusion_pytorch_model.safetensors", unet, ucfg)
    if vae is not None:
        vcfg = dataclasses.asdict(vae_config) if vae_config else {}
        vcfg["_class_name"] = "AutoencoderKL"
        total += _save_component(out_dir, "vae", "diffusion_pytorch_model.safetensors", vae,
                                 vcfg)
    if text_encoder is not None:
        tcfg = dataclasses.asdict(text_config) if text_config else {}
        total += _save_component(out_dir, "text_encoder", "model.safetensors", text_encoder,
                                 tcfg)
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump({"_class_name": "LatentToVideoPipeline",
                   "framework": "animate_anything_tpu_torch"}, f, indent=2)
    return total


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_pipeline_components(model_dir: str) -> dict[str, Any]:
    """A diffusers-layout directory → {``unet_config``, ``unet``,
    ``vae_config``, ``vae``, ``text_config``, ``text_encoder``,
    ``scheduler_config``}, each present where its directory or file is; the
    weights as loaded (CPU tensors, checkpoint key names)."""
    out: dict[str, Any] = {}
    for sub, key, cfg_key in (("unet", "unet", "unet_config"), ("vae", "vae", "vae_config"),
                              ("text_encoder", "text_encoder", "text_config")):
        path = os.path.join(model_dir, sub)
        if os.path.isdir(path):
            out[cfg_key] = _load_json(os.path.join(path, "config.json"))
            out[key] = load_state_dict(path)
    sched = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    if os.path.exists(sched):
        out["scheduler_config"] = _load_json(sched)
    return out
