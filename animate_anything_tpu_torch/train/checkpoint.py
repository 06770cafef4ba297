"""Train-state checkpoints and diffusers-layout pipeline directories — the
port of ``animate_anything_tpu/train/checkpoint.py``.

**Train state** (orbax in JAX, a torch state file here): ``save_checkpoint``
writes ``{ckpt_dir}/step_{step:08d}/train_state.pt`` (the trainable fp32
masters, or the adapter, the optimizer's moments and counts, the step) and
keeps the newest ``keep`` = 3; ``restore_checkpoint`` copies one back into a
freshly made state of the same run (restore-into-template, as orbax's), so a
resumed run goes on at the saved step. Under data parallelism the
optimizer's ZeRO slices are gathered whole to rank 0, which writes, so the
file is the one-device file, and a run at any rank count resumes from it.
Under tensor parallelism (``parallel/tensor.py``) the tensor ranks' slices of
each split master and of its moments are gathered on rank 0 too, the GEGLU
val/gate pairing undone, and a restore takes each rank's slice of the whole
arrays. The 8-bit moments of a split array cross the file through fp32: a
rank's blocks are dequantized, joined and requantized in the whole array's
blocks (and the reverse on a restore), within one quantization level of the
live state. The files are the port's own: orbax interop is not kept.

**Pipelines.** A directory holds ``unet/``, ``vae/`` and ``text_encoder/``, each with a
``config.json`` (the config dataclass as a dict) and its weights in fp32
safetensors under diffusers / HF key names, and ``model_index.json``;
``scheduler/scheduler_config.json`` is read where present. The JAX package
writes and reads the same layout, so a directory written by either side
loads into the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import torch
from safetensors.torch import save_file

from animate_anything_tpu_torch.utils.convert import load_state_dict


STATE_FILE = "train_state.pt"


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


_MOMENTS = ("mu", "nu", "acc")                 # AdamW's per-element state
_QUANTIZED = (("m_q", "m_scale", True), ("v_q", "v_scale", False))   # the 8-bit moments


def _tp_split(state) -> tuple:
    """(tensor axis, {master name: (dim, paired)}) of the masters a
    tensor-split model holds as slices, or (None, {})."""
    from animate_anything_tpu_torch.parallel.tensor import model_plan

    tp, plan = model_plan(state.model)
    return tp, {n: plan[n] for n in state.masters if n in plan}


def _dequantized(q, scale, shape):
    from animate_anything_tpu_torch.ops.adam8bit import dequantize, unblocked

    return unblocked(dequantize(q, scale), shape, torch.float32)


def _quantized(x, signed: bool, dtype):
    from animate_anything_tpu_torch.ops.adam8bit import blocked, quantize, unblocked

    q, scale = quantize(blocked(x), signed)
    return unblocked(q, x.shape, dtype), scale


def _gather_tensor_slices(state, optimizer):
    """The masters and the optimizer state with every tensor-split array
    whole, on the tensor axis's rank 0 (None for both elsewhere). A
    collective over the axis: the ranks whose optimizer state the data
    gather left them call it."""
    from animate_anything_tpu_torch.parallel.tensor import gather_full

    tp, split = _tp_split(state)
    masters = dict(state.masters)
    opt = {k: dict(v) if isinstance(v, dict) else v for k, v in optimizer.items()}
    main = tp.rank == 0
    for n, (dim, paired) in split.items():
        dev = state.masters[n].device

        def whole(t):
            return gather_full(t.to(dev), dim, paired, tp)

        masters[n] = whole(masters[n])
        for key in _MOMENTS:
            if opt.get(key) is not None and n in opt[key]:
                opt[key][n] = whole(opt[key][n])
        for qk, sk, signed in _QUANTIZED:
            if qk in opt:
                q = opt[qk][n]
                full = whole(_dequantized(q.to(dev), opt[sk][n].to(dev), q.shape))
                if main:
                    opt[qk][n], opt[sk][n] = _quantized(full, signed, q.dtype)
    return (masters, opt) if main else (None, None)


def _take_tensor_slices(state, saved: dict) -> dict:
    """A file's whole masters and optimizer state → this rank's slices of
    the tensor-split arrays (the rest as saved)."""
    from animate_anything_tpu_torch.parallel.tensor import local_slice

    tp, split = _tp_split(state)
    if tp is None:
        return saved
    masters = dict(saved["masters"])
    opt = {k: dict(v) if isinstance(v, dict) else v for k, v in saved["optimizer"].items()}
    for n, (dim, paired) in split.items():
        def mine(t):
            return local_slice(t, dim, paired, tp).contiguous()

        masters[n] = mine(masters[n])
        for key in _MOMENTS:
            if opt.get(key) is not None and n in opt[key]:
                opt[key][n] = mine(opt[key][n])
        for qk, sk, signed in _QUANTIZED:
            if qk in opt:
                q = opt[qk][n]
                shape = saved["masters"][n].shape
                part = mine(_dequantized(q.reshape(-1), opt[sk][n], shape))
                opt[qk][n], opt[sk][n] = _quantized(part, signed, q.dtype)
    return {**saved, "masters": masters, "optimizer": opt}


def save_checkpoint(ckpt_dir: str, state, keep: int = 3) -> str:
    """Write ``state`` (``train.TrainState``) under ``ckpt_dir/step_{step:08d}``
    and prune to the newest ``keep`` steps; → the step's directory. Under data
    or tensor parallelism every rank calls it: the optimizer's slices and the
    tensor-split masters are gathered whole to rank 0, which alone writes
    the file a one-device run writes."""
    from animate_anything_tpu_torch.core.mesh import is_main_process

    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{int(state.step):08d}")
    optimizer = state.optimizer.state_dict()
    masters = state.masters
    if _tp_split(state)[0] is not None and optimizer is not None:
        masters, optimizer = _gather_tensor_slices(state, optimizer)
    if not is_main_process():
        return path
    os.makedirs(path, exist_ok=True)
    torch.save({"masters": _to_host(masters),
                "optimizer": _to_host(optimizer),
                "step": int(state.step)}, os.path.join(path, STATE_FILE))
    entries = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for old in entries[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


@torch.no_grad()
def restore_checkpoint(path: str, state):
    """Copy the checkpoint at ``path`` (a ``step_*`` directory) into
    ``state``'s tensors, which must have its names and shapes; rounds
    restored masters into the working module; → ``state``. A
    tensor-split state takes its slices of the file's whole arrays."""
    from animate_anything_tpu_torch.core.dtypes import copy_masters_

    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", mmap=True,
                       weights_only=True)
    if set(saved["masters"]) != set(state.masters):
        raise ValueError(f"checkpoint {path}: its tensors are not this state's")
    saved = _take_tensor_slices(state, saved)
    for name, t in state.masters.items():
        t.copy_(saved["masters"][name])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    if state.model is not None:
        copy_masters_(state.model, state.masters)
    return state


def save_component(out_dir: str, sub: str, weights: str, module: torch.nn.Module,
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
    total = save_component(out_dir, "unet", "diffusion_pytorch_model.safetensors", unet, ucfg)
    if vae is not None:
        vcfg = dataclasses.asdict(vae_config) if vae_config else {}
        vcfg["_class_name"] = "AutoencoderKL"
        total += save_component(out_dir, "vae", "diffusion_pytorch_model.safetensors", vae,
                                 vcfg)
    if text_encoder is not None:
        tcfg = dataclasses.asdict(text_config) if text_config else {}
        total += save_component(out_dir, "text_encoder", "model.safetensors", text_encoder,
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
