"""LoRA: low-rank adaptation as a transform of a dict of weights — the port
of ``animate_anything_tpu/models/lora.py``.

An adapter is a dict ``{flax path: {"down": (fan_in, r), "up": (r,
fan_out)}}`` of fp32 tensors, keyed as JAX keys it: the dotted flax path of
the adapted kernel, without ``params.`` (``utils/convert.flax_path`` for the
UNet, ``clip_flax_path`` for the CLIP text encoder). ``lora_params`` gives a
module's weights under the same keys, in the port's layout.

- Targets: a ``.kernel`` whose FLAX rank is 2 (every Linear and 1×1
  projection), or 4 under ``include_convs`` (the 3×3 convs, and the temporal
  convs, whose port weights are (O, I, kt, 1, 1) against flax's (kt, 1, I,
  O)), matched by the reference's module-class names
  (``_CLASS_NAME_PATTERNS``) as path substrings.
- Init: down ~ N(0, 1)/r, up = 0, from an explicit ``torch.Generator``.
- Merge: W' = W + (α/r)·(down @ up) in W's dtype, the product reshaped
  to the flax kernel's shape and permuted into the port's layout;
  ``merged_weights`` casts it to the parameter's dtype (an fp32 base → the
  compute dtype, as JAX's fp32 parameters are cast). ``substituted`` puts
  merged weights into a module for the length of a ``with`` block, forward
  and backward both, so a recomputing checkpoint reads them too.
- Rank dropout: inverted scaling, one Bernoulli per rank column.
- Files: safetensors with JAX's keys (``{prefix}.{path}.lora_down.weight``
  as (r, fan_in), ``lora_up`` as (fan_out, r)) and metadata (``rank``,
  ``alpha``, ``targets``, ``include_convs``); either side reads the other's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from animate_anything_tpu_torch.utils.convert import clip_flax_path, flax_path

# reference module-class names (unet_lora_modules / text_encoder_lora_modules
# in the YAMLs) → flax-path substrings
_CLASS_NAME_PATTERNS = {
    "UNet3DConditionModel": ("",),                       # everything
    "CLIPTextModel": ("",),
    "CLIPEncoderLayer": ("layers_",),
    "CLIPAttention": ("q_proj", "k_proj", "v_proj", "out_proj"),
    "CrossAttention": ("attn1", "attn2"),
    "Attention": ("attn1", "attn2"),
    "Transformer2DModel": ("attentions_",),
    "TransformerTemporalModel": ("temp_attentions_", "transformer_in"),
    "ResnetBlock2D": ("resnets_",),
    "TemporalConvLayer": ("temp_convs_",),
    "GEGLU": ("net_0_proj",),
}

Lora = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: Optional[float] = None        # defaults to rank (scale 1)
    targets: Tuple[str, ...] = ("CrossAttention",)
    include_convs: bool = False
    # train-time rank dropout: each step keeps a rank column with
    # probability 1 - dropout, scaled by 1/(1 - dropout); none at merge time
    dropout: float = 0.0

    @property
    def scale(self) -> float:
        return (self.alpha if self.alpha is not None else self.rank) / self.rank


def _patterns(cfg: LoraConfig) -> Tuple[str, ...]:
    pats: list[str] = []
    for t in cfg.targets:
        pats.extend(_CLASS_NAME_PATTERNS.get(t, (t,)))
    return tuple(pats)


def flax_shape(shape) -> Tuple[int, ...]:
    """A port weight's shape → its flax kernel's: Linear (O, I) → (I, O),
    conv (O, I, kh, kw) → (kh, kw, I, O), temporal conv (O, I, kt, 1, 1) →
    (kt, 1, I, O)."""
    shape = tuple(shape)
    if len(shape) == 2:
        return shape[::-1]
    if len(shape) in (4, 5):
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


def to_port_layout(w: torch.Tensor, port_shape) -> torch.Tensor:
    """A tensor in a flax kernel's layout → the port weight's (``flax_shape``
    inverted)."""
    if len(port_shape) == 2:
        return w.t()
    if len(port_shape) == 4:
        return w.permute(3, 2, 0, 1)
    if len(port_shape) == 5:
        return w.permute(3, 2, 0, 1)[..., None]
    return w


def flax_names(module: nn.Module, naming: str = "unet") -> Dict[str, str]:
    """{flax path (no ``params.``): port parameter name} of ``module``'s
    parameters; ``naming`` "unet" (diffusers keys) or "text" (HF CLIP keys)."""
    if naming == "unet":
        return {flax_path(n, p.ndim)[len("params."):]: n for n, p in module.named_parameters()}
    if naming == "text":
        return {clip_flax_path(n, p.ndim): n for n, p in module.named_parameters()}
    raise ValueError(f"naming must be 'unet' or 'text', got {naming!r}")


def lora_params(module: nn.Module, naming: str = "unet") -> Dict[str, torch.Tensor]:
    """``module``'s parameters keyed by flax path, in the port's layout."""
    named = dict(module.named_parameters())
    return {path: named[name] for path, name in flax_names(module, naming).items()}


def _is_target(path: str, w: torch.Tensor, cfg: LoraConfig) -> bool:
    if not path.endswith(".kernel"):
        return False
    rank = len(flax_shape(w.shape))
    if not (rank == 2 or (rank == 4 and cfg.include_convs)):
        return False
    return any(p in path or p == "" for p in _patterns(cfg))


def init_lora_params(generator: torch.Generator, params: Dict[str, torch.Tensor],
                     cfg: LoraConfig) -> Lora:
    """→ {path: {"down": (fan_in, r), "up": (r, fan_out)}} fp32 on the
    generator's device, paths in sorted order: down ~ N(0, 1)/r, up = 0, so
    the adapter starts as the identity."""
    lora: Lora = {}
    for path in sorted(params):
        w = params[path]
        if not _is_target(path, w, cfg):
            continue
        fshape = flax_shape(w.shape)
        fan_in, fan_out = 1, fshape[-1]
        for d in fshape[:-1]:
            fan_in *= d
        down = torch.randn((fan_in, cfg.rank), generator=generator, device=generator.device)
        lora[path] = {"down": down / cfg.rank,
                      "up": torch.zeros((cfg.rank, fan_out), device=generator.device)}
    if not lora:
        raise ValueError(f"no LoRA targets matched {cfg.targets}")
    return lora


def merge_lora(params: Dict[str, torch.Tensor], lora: Lora,
               cfg: LoraConfig) -> Dict[str, torch.Tensor]:
    """{path: W'} for every entry of ``params``: W + (α/r)·(down @ up) where
    ``lora`` adapts the path (the product in W's dtype, in W's layout), W
    itself elsewhere. Gradients reach the adapter, never the base."""
    out = {}
    for path, w in params.items():
        base = w.detach()
        if path in lora:
            delta = (lora[path]["down"] @ lora[path]["up"]).to(w.dtype)
            base = base + cfg.scale * to_port_layout(delta.reshape(flax_shape(w.shape)), w.shape)
        out[path] = base
    return out


def dropout_lora(lora: Lora, cfg: LoraConfig, generator: Optional[torch.Generator] = None,
                 keep: Optional[Dict[str, torch.Tensor]] = None) -> Lora:
    """Rank-column dropout for a training step: each adapter keeps column r
    with probability 1 - p (``keep[path]``, a (rank,) bool tensor, when
    given, else drawn from ``generator`` in sorted path order), kept columns
    of ``down`` scaled by 1/(1 - p)."""
    if not cfg.dropout:
        return lora
    keep_p = 1.0 - cfg.dropout
    out: Lora = {}
    for path in sorted(lora):
        down = lora[path]["down"]
        if keep is not None:
            k = keep[path].to(down.device)
        else:
            k = torch.rand((cfg.rank,), generator=generator, device=down.device) < keep_p
        out[path] = {"down": down * (k.float() / keep_p)[None, :], "up": lora[path]["up"]}
    return out


@contextlib.contextmanager
def substituted(module: nn.Module, weights: Dict[str, torch.Tensor]) -> Iterator[None]:
    """``module``'s parameters named in ``weights`` (port names) replaced by
    those tensors until the block ends: forward and backward inside the
    block read them (a conv weight kept channels_last where its parameter
    is), then the parameters come back unchanged."""
    saved = []
    try:
        for name, w in weights.items():
            owner, _, leaf = name.rpartition(".")
            sub = module.get_submodule(owner)
            orig = sub._parameters[leaf]
            if w.ndim == 4 and orig.is_contiguous(memory_format=torch.channels_last):
                w = w.contiguous(memory_format=torch.channels_last)
            saved.append((sub, leaf, orig))
            sub._parameters[leaf] = w
        yield
    finally:
        for sub, leaf, orig in saved:
            sub._parameters[leaf] = orig


def merged_weights(module: nn.Module, base: Dict[str, torch.Tensor], lora: Lora,
                   cfg: LoraConfig, naming: str = "unet") -> Dict[str, torch.Tensor]:
    """The adapted weights of ``module`` by port name, for ``substituted``:
    ``base`` (flax path → the adapted kernels' base, e.g. fp32 copies)
    merged with ``lora`` and cast to the parameter's dtype."""
    names = flax_names(module, naming)
    named = dict(module.named_parameters())
    merged = merge_lora({p: base[p] for p in lora}, lora, cfg)
    return {names[p]: w.to(named[names[p]].dtype) for p, w in merged.items()}


@torch.no_grad()
def collapse_lora_(module: nn.Module, lora: Lora, cfg: LoraConfig,
                   naming: str = "unet") -> nn.Module:
    """Fold ``lora`` into ``module``'s weights for good, in their dtype (a
    saved adapter at inference)."""
    params = lora_params(module, naming)
    merged = merge_lora({p: params[p] for p in lora}, lora, cfg)
    for path, w in merged.items():
        params[path].copy_(w)
    return module


# --------------------------------------------------------------------------
# Persistence: safetensors with rank metadata, torch-layout keys
# --------------------------------------------------------------------------

def save_lora(path: str, lora: Lora, cfg: LoraConfig, prefix: str = "unet") -> str:
    from safetensors.torch import save_file

    sd = {}
    for ps, ab in lora.items():
        base = f"{prefix}.{ps[: -len('.kernel')]}"
        # torch linear layout (out, in): down (r, fan_in), up (fan_out, r)
        sd[f"{base}.lora_down.weight"] = ab["down"].detach().float().t().contiguous().cpu()
        sd[f"{base}.lora_up.weight"] = ab["up"].detach().float().t().contiguous().cpu()
    meta = {"rank": str(cfg.rank), "alpha": str(cfg.alpha or cfg.rank),
            "targets": json.dumps(list(cfg.targets)),
            "include_convs": str(cfg.include_convs)}
    save_file(sd, path, metadata=meta)
    return path


def load_lora(path: str, prefix: str = "unet", device="cpu") -> tuple[Lora, LoraConfig]:
    from safetensors import safe_open

    lora: Lora = {}
    with safe_open(path, framework="pt", device="cpu") as f:
        meta = f.metadata() or {}
        for key in f.keys():
            if not key.startswith(prefix + "."):
                continue
            stem = key[len(prefix) + 1:]
            for tag, part in ((".lora_down.weight", "down"), (".lora_up.weight", "up")):
                if stem.endswith(tag):
                    ps = stem[: -len(tag)] + ".kernel"
                    lora.setdefault(ps, {})[part] = f.get_tensor(key).t().contiguous().to(device)
    cfg = LoraConfig(
        rank=int(meta.get("rank", 16)),
        alpha=float(meta["alpha"]) if "alpha" in meta else None,
        targets=tuple(json.loads(meta.get("targets", '["CrossAttention"]'))),
        include_convs=meta.get("include_convs", "False") == "True",
    )
    return lora, cfg
