"""Weight carry-over from the JAX package, and the flax initialisers in torch.

``unet3d_state_dict`` / ``vae_state_dict`` / ``clip_text_state_dict`` take
the JAX package's param trees (nested dicts of numpy-convertible arrays,
optionally under ``"params"``) and return the port's state dicts in the
diffusers / HF key layout. They are a numpy-only copy of
``animate_anything_tpu/utils/import_torch.py`` (``_flatten_tree``,
``_unflatten_lists``, ``_export_tensor``, ``export_unet3d``, ``export_vae``,
``export_clip_text``), so this module needs no JAX.

``init_unet3d_`` / ``init_vae_`` / ``init_clip_text_`` draw fresh weights the
way the flax modules initialise theirs (lecun-normal kernels, zero biases,
unit norm scales, the zero-initialised last temporal conv, normal
embeddings), from an explicit ``torch.Generator``; the machine with the card
has no JAX.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import numpy as np
import torch

_LIST_ATTRS = (
    "down_blocks|up_blocks|resnets|attentions|temp_attentions|temp_convs|"
    "transformer_blocks|downsamplers|upsamplers|layers|motion_modules"
)


def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_lists(key: str) -> str:
    return re.sub(rf"\b({_LIST_ATTRS})_(\d+)", r"\1.\2", key)


def _export_tensor(key: str, w: np.ndarray, temporal: bool) -> tuple[str, np.ndarray]:
    if key.endswith(".kernel"):
        base = key[: -len(".kernel")]
        if w.ndim == 4 and temporal:          # (kt,1,I,O) → (O,I,kt,1,1)
            return base + ".weight", w.transpose(3, 2, 0, 1)[..., None]
        if w.ndim == 4:                       # (kh,kw,I,O) → (O,I,kh,kw)
            return base + ".weight", w.transpose(3, 2, 0, 1)
        if w.ndim == 2:
            return base + ".weight", w.T
    if key.endswith(".embedding"):
        return key[: -len(".embedding")] + ".weight", w
    if key.endswith(".scale"):
        return key[: -len(".scale")] + ".weight", w
    return key, w


def _to_torch(w) -> torch.Tensor:
    a = np.asarray(w)
    if a.dtype not in (np.float16, np.float32, np.float64):
        a = a.astype(np.float32)      # e.g. bfloat16 from ml_dtypes
    return torch.from_numpy(np.ascontiguousarray(a))


def unet3d_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNet3DConditionModel`` params → the port's state dict."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        temporal = "temp_convs" in key
        k = _unflatten_lists(key)
        if temporal:
            k = re.sub(r"\.norm(\d)\.", r".conv\1.0.", k)
            k = re.sub(r"\.conv1\.(kernel|bias)$", r".conv1.2.\1", k)
            k = re.sub(r"\.conv([234])\.(kernel|bias)$", r".conv\1.3.\2", k)
        k = k.replace(".to_out_0.", ".to_out.0.")
        k = k.replace(".ff.net_0_proj.", ".ff.net.0.proj.")
        k = k.replace(".ff.net_2.", ".ff.net.2.")
        k, w = _export_tensor(k, np.asarray(w), temporal)
        out[k] = _to_torch(w)
    return out


def clip_text_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextModel`` params → the port's state dict (HF key layout)."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k = _unflatten_lists(key)
        k = re.sub(r"^layers\.", "encoder.layers.", k)
        k = re.sub(r"\.([qkv]_proj|out_proj)\.", r".self_attn.\1.", k)
        k = k.replace(".fc1.", ".mlp.fc1.").replace(".fc2.", ".mlp.fc2.")
        if k.startswith(("token_embedding.", "position_embedding.")):
            k = "embeddings." + k
        k, w = _export_tensor(k, np.asarray(w), False)
        out["text_model." + k] = _to_torch(w)
    return out


def vae_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params → the port's state dict."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k = re.sub(r"\.(down|up)_blocks_(\d+)_resnets_(\d+)\.", r".\1_blocks.\2.resnets.\3.", key)
        k = re.sub(r"\.down_blocks_(\d+)_downsample\.", r".down_blocks.\1.downsamplers.0.conv.", k)
        k = re.sub(r"\.up_blocks_(\d+)_upsample\.", r".up_blocks.\1.upsamplers.0.conv.", k)
        k = re.sub(r"\.mid_resnets_(\d+)\.", r".mid_block.resnets.\1.", k)
        k = k.replace(".mid_attn.to_out_0.", ".mid_block.attentions.0.to_out.0.")
        k = k.replace(".mid_attn.", ".mid_block.attentions.0.")
        k, w = _export_tensor(k, np.asarray(w), False)
        out[k] = _to_torch(w)
    return out


# ---------------------------------------------------------------------------
# flax initialisers
# ---------------------------------------------------------------------------

# lecun_normal = variance_scaling(1, "fan_in", "truncated_normal"): a normal
# truncated at ±2σ, with σ corrected so the truncated law has variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978
_PHI_2 = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))   # Φ(2)


@torch.no_grad()
def _lecun_normal_(p: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    buf = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    buf.uniform_(1.0 - 2.0 * _PHI_2, 2.0 * _PHI_2 - 1.0, generator=gen)
    buf.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    p.copy_(buf)


@torch.no_grad()
def _init_flax_(module: torch.nn.Module, gen: torch.Generator, zero: tuple = ()) -> None:
    for name, p in module.named_parameters():
        if name.endswith(".bias") or p.ndim == 1 and not name.endswith(".weight"):
            p.zero_()
        elif p.ndim == 1:           # LayerNorm / GroupNorm scale
            p.fill_(1.0)
        elif any(name.startswith(z) for z in zero):
            p.zero_()
        else:                       # Linear (O, I), Conv (O, I, *k): fan_in = I·Πk
            _lecun_normal_(p, p[0].numel(), gen)


def init_unet3d_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the UNet's weights as the flax modules do; the last temporal conv
    of every TemporalConvLayer (``conv4``) starts at zero, so the layer is the
    identity at init."""
    zero = tuple(n.rsplit(".", 1)[0] for n, _ in module.named_parameters()
                 if re.search(r"temp_convs\.\d+\.conv4\.3\.weight$", n))
    _init_flax_(module, generator, zero)
    return module


def init_vae_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    _init_flax_(module, generator)
    return module


@torch.no_grad()
def init_clip_text_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the CLIP text encoder's weights as the flax modules do: embeddings
    by ``nn.Embed``'s default (variance scaling 1, fan-in, normal: N(0, 1/hidden)
    over an (vocab, hidden) table), lecun-normal Dense kernels, zero biases,
    unit LayerNorm scales."""
    for name, p in module.named_parameters():
        if name.endswith("embedding.weight"):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                    / math.sqrt(p.shape[1]))
        elif name.endswith(".bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            _lecun_normal_(p, p.shape[1], generator)
    return module
