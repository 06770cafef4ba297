"""Weight carry-over from the JAX package, and the flax initialisers in torch.

``unet3d_state_dict`` / ``vae_state_dict`` / ``clip_text_state_dict`` /
``svd_unet_state_dict`` / ``clip_vision_state_dict`` / ``unet384_state_dict`` /
``offset_encoder_state_dict`` / ``lama_state_dict`` take the JAX package's
param trees (nested dicts of numpy-convertible arrays, optionally under
``"params"``) and return the port's state dicts in the diffusers / HF key
layout. They are a numpy-only copy of
``animate_anything_tpu/utils/import_torch.py`` (``_flatten_tree``,
``_unflatten_lists``, ``_export_tensor``, ``export_unet3d``, ``export_vae``,
``export_clip_text``, ``export_svd_unet``; CLIP vision is the inverse of its
``_rename_clip_vision``), so this module needs no JAX.

``load_state_dict`` reads a torch state dict from a weight file or a
diffusers model directory, and ``checkpoint_state_dict`` fits one to the
port's modules (the keys that no forward reads dropped, the conv_in →
conv_in2 surgery of ``expand_conv_in_channels``), the keys otherwise kept
as they are: the port's modules carry diffusers names.

``init_unet3d_`` / ``init_vae_`` / ``init_clip_text_`` / ``init_svd_unet_`` /
``init_clip_vision_`` / ``init_unet384_`` / ``init_offset_encoder_`` / ``init_lama_`` draw
fresh weights the way the flax modules initialise theirs (lecun-normal
kernels, zero biases, unit norm scales, the zero-initialised last temporal
conv and LayerDiffuse convs, normal embeddings, the SVD mixers' 0.5), from
an explicit ``torch.Generator``; the machine with the card has no JAX.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict

import numpy as np
import torch
from safetensors.torch import load_file

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


def _unet3d_renamed(key: str) -> str:
    """A flattened JAX UNet param path → the diffusers key, leaf name kept."""
    k = _unflatten_lists(key)
    if "temp_convs" in key:
        k = re.sub(r"\.norm(\d)\.", r".conv\1.0.", k)
        k = re.sub(r"\.conv1\.(kernel|bias)$", r".conv1.2.\1", k)
        k = re.sub(r"\.conv([234])\.(kernel|bias)$", r".conv\1.3.\2", k)
    k = k.replace(".to_out_0.", ".to_out.0.")
    k = k.replace(".ff.net_0_proj.", ".ff.net.0.proj.")
    return k.replace(".ff.net_2.", ".ff.net.2.")


def unet3d_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNet3DConditionModel`` params → the port's state dict."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k, w = _export_tensor(_unet3d_renamed(key), np.asarray(w), "temp_convs" in key)
        out[k] = _to_torch(w)
    return out


def flax_path(name: str, ndim: int) -> str:
    """The inverse of ``unet3d_state_dict``'s key map: a port parameter name
    (diffusers layout) and its rank → the dotted flax path of the same
    parameter, ``params.`` prefix included, as JAX's trainer matches it
    (``trainable_label_tree``). Works for any module of the port's naming
    (``Linear``/``Conv`` weights → ``kernel``, 1-d weights → ``scale``)."""
    k = name
    if k.endswith(".weight"):
        k = k[: -len(".weight")] + (".kernel" if ndim >= 2 else ".scale")
    if "temp_convs" in k:
        k = re.sub(r"\.conv(\d)\.0\.", r".norm\1.", k)
        k = re.sub(r"\.conv(\d)\.[23]\.(kernel|bias)$", r".conv\1.\2", k)
    k = k.replace(".to_out.0.", ".to_out_0.")
    k = k.replace(".ff.net.0.proj.", ".ff.net_0_proj.")
    k = k.replace(".ff.net.2.", ".ff.net_2.")
    return "params." + re.sub(rf"\b({_LIST_ATTRS})\.(\d+)", r"\1_\2", k)


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


def clip_flax_path(name: str, ndim: int) -> str:
    """The inverse of ``clip_text_state_dict``'s key map: a port CLIP text
    parameter name (HF layout) and its rank → the dotted flax path, without
    ``params.``, as JAX's ``models/lora.py`` names the text encoder's leaves."""
    k = name[len("text_model."):] if name.startswith("text_model.") else name
    k = k.replace("embeddings.", "").replace("encoder.layers.", "layers.")
    k = k.replace(".self_attn.", ".").replace(".mlp.", ".")
    if k.endswith("embedding.weight"):
        k = k[: -len(".weight")] + ".embedding"
    elif k.endswith(".weight"):
        k = k[: -len(".weight")] + (".kernel" if ndim >= 2 else ".scale")
    return re.sub(rf"\b({_LIST_ATTRS})\.(\d+)", r"\1_\2", k)


def svd_unet_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNetSpatioTemporalConditionModel`` params → the port's state
    dict (JAX's ``export_svd_unet``): the temporal resnets' (3, 1, I, O)
    kernels become (O, I, 3, 1, 1), ``time_mixer_N`` collapses to
    ``time_mixer``, ``ff_in`` and ``ff`` take diffusers' ``net.N`` names."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k = re.sub(r"^(down|up)_blocks_(\d+)_(resnets|attentions)_(\d+)\.",
                   r"\1_blocks.\2.\3.\4.", key)
        k = re.sub(r"^down_blocks_(\d+)_downsample\.conv\.",
                   r"down_blocks.\1.downsamplers.0.conv.", k)
        k = re.sub(r"^up_blocks_(\d+)_upsample\.conv\.", r"up_blocks.\1.upsamplers.0.conv.", k)
        k = re.sub(r"^mid_resnets_(\d+)\.", r"mid_block.resnets.\1.", k)
        k = re.sub(r"^mid_attentions_(\d+)\.", r"mid_block.attentions.\1.", k)
        k = re.sub(r"\b(temporal_)?transformer_blocks_(\d+)\b", r"\1transformer_blocks.\2", k)
        k = re.sub(r"\btime_mixer_(\d+)\b", r"time_mixer", k)
        k = k.replace(".to_out_0.", ".to_out.0.")
        k = re.sub(r"\.(ff|ff_in)\.net_0_proj\.", r".\1.net.0.proj.", k)
        k = re.sub(r"\.(ff|ff_in)\.net_2\.", r".\1.net.2.", k)
        k, w = _export_tensor(k, np.asarray(w), ".temporal_res_block." in "." + key)
        out[k] = _to_torch(w)
    return out


def svd_flax_path(name: str, ndim: int) -> str:
    """The inverse of ``svd_unet_state_dict``'s key map: a port SVD UNet
    parameter name and its rank → the dotted flax path, ``params.`` prefix
    included, as JAX's trainer matches it (``trainable_label_tree``)."""
    k = name
    if k.endswith(".weight"):
        k = k[: -len(".weight")] + (".kernel" if ndim >= 2 else ".scale")
    k = re.sub(r"^(down|up)_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.",
               r"\1_blocks_\2_\3_\4.", k)
    k = re.sub(r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
               r"down_blocks_\1_downsample.conv.", k)
    k = re.sub(r"^up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r"up_blocks_\1_upsample.conv.", k)
    k = re.sub(r"^mid_block\.(resnets|attentions)\.(\d+)\.", r"mid_\1_\2.", k)
    k = re.sub(r"\b(temporal_)?transformer_blocks\.(\d+)\b", r"\1transformer_blocks_\2", k)
    if re.match(r"^(down_blocks_\d+_attentions_|up_blocks_\d+_attentions_|mid_attentions_)", k):
        k = k.replace(".time_mixer.", ".time_mixer_0.")
    k = k.replace(".to_out.0.", ".to_out_0.")
    k = re.sub(r"\.(ff|ff_in)\.net\.0\.proj\.", r".\1.net_0_proj.", k)
    k = re.sub(r"\.(ff|ff_in)\.net\.2\.", r".\1.net_2.", k)
    return "params." + k


def clip_vision_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPVisionModelWithProjection`` params → the port's state dict
    (HF ``CLIPVisionModelWithProjection`` keys; the inverse of JAX's
    ``_rename_clip_vision``)."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k = _unflatten_lists(key)
        k = re.sub(r"^layers\.", "encoder.layers.", k)
        k = re.sub(r"\.([qkv]_proj|out_proj)\.", r".self_attn.\1.", k)
        k = k.replace(".fc1.", ".mlp.fc1.").replace(".fc2.", ".mlp.fc2.")
        if k.startswith(("class_embedding", "patch_embedding.", "position_embedding.")):
            k = "embeddings." + k
        k, w = _export_tensor(k, np.asarray(w), False)
        out[k if k.startswith("visual_projection.") else "vision_model." + k] = _to_torch(w)
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


def unet384_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNet384`` params → the port's state dict (the reference's torch
    keys: the inverse of JAX's ``convert_unet384``)."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k = re.sub(r"^(down|up)_blocks_(\d+)_(resnets|attentions)_(\d+)\.",
                   r"\1_blocks.\2.\3.\4.", key)
        k = re.sub(r"^down_blocks_(\d+)_downsample\.conv\.",
                   r"down_blocks.\1.downsamplers.0.conv.", k)
        k = re.sub(r"^up_blocks_(\d+)_upsample\.conv\.", r"up_blocks.\1.upsamplers.0.conv.", k)
        k = re.sub(r"^mid_resnets_(\d+)\.", r"mid_block.resnets.\1.", k)
        k = re.sub(r"^mid_attn\.", "mid_block.attentions.0.", k)
        k = k.replace(".to_out_0.", ".to_out.0.")
        k, w = _export_tensor(k, np.asarray(w), False)
        out[k] = _to_torch(w)
    return out


def offset_encoder_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LatentTransparencyOffsetEncoder`` params → the port's state dict
    (``blocks.N.``: the inverse of JAX's ``convert_offset_encoder``)."""
    tree = params.get("params", params)
    out = {}
    for key, w in _flatten_tree(tree).items():
        k, w = _export_tensor(re.sub(r"^blocks_(\d+)\.", r"blocks.\1.", key), np.asarray(w),
                              False)
        out[k] = _to_torch(w)
    return out


# ---------------------------------------------------------------------------
# diffusers-layout checkpoints
# ---------------------------------------------------------------------------

WEIGHT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                "diffusion_pytorch_model.bin", "pytorch_model.bin")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict (CPU tensors, stored dtypes) from a weight file, or
    from a diffusers model directory by the first of ``WEIGHT_NAMES`` in it:
    ``.safetensors`` through ``safetensors.torch``, ``.bin`` through
    ``torch.load(weights_only=True)``, a ``state_dict`` entry unwrapped."""
    if os.path.isdir(path):
        for name in WEIGHT_NAMES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no weight file found in {path}")
    if path.endswith(".safetensors"):
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def expand_conv_in_channels(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The conv_in → conv_in2 surgery for a checkpoint without the mask
    channel: ``conv_in2`` takes ``conv_in``'s kernel with a zero input
    channel in front (the mask's, which the UNet concatenates first) and its
    bias; ``conv_in`` goes, as the mask UNet has none."""
    out = {k: v for k, v in sd.items() if not k.startswith("conv_in.")}
    w = sd["conv_in.weight"]                                  # (O, I, kh, kw)
    out["conv_in2.weight"] = torch.cat([torch.zeros_like(w[:, :1]), w], dim=1)
    out["conv_in2.bias"] = sd["conv_in.bias"]
    return out


# Keys of diffusers / HF checkpoints that no forward reads (JAX's importer
# drops the same): the reference's unused motion MLP, attention dropout, the
# CLIP position ids and projection heads.
_UNUSED = {
    "unet": (r"^motion_embedding\.", r"^motion_proj\.", r"\.to_out\.1\."),
    "vae": (),
    "text_encoder": (r"^(text_model\.embeddings\.)?position_ids$",
                     r"^(text_projection|logit_scale|visual_projection)"),
}


def checkpoint_state_dict(component: str, sd: Dict[str, torch.Tensor],
                          motion_mask: bool = False) -> Dict[str, torch.Tensor]:
    """A loaded ``unet`` / ``vae`` / ``text_encoder`` state dict → the keys of
    the port's module: unused keys dropped; a mask UNet takes ``conv_in2``
    (made by the conv_in surgery where the checkpoint lacks it) and a UNet
    without the mask ``conv_in``, the other one left out as JAX's loader
    ignores it."""
    drop = [re.compile(p) for p in _UNUSED[component]]
    out = {k: v for k, v in sd.items() if not any(p.search(k) for p in drop)}
    if component == "unet" and motion_mask:
        if "conv_in2.weight" not in out and "conv_in.weight" in out:
            out = expand_conv_in_channels(out)
        out = {k: v for k, v in out.items() if not k.startswith("conv_in.")}
    elif component == "unet":
        out = {k: v for k, v in out.items() if not k.startswith("conv_in2.")}
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
def init_svd_unet_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the SVD UNet's weights as the flax modules do; every
    ``AlphaBlender.mix_factor`` starts at 0.5 (an even mix)."""
    _init_flax_(module, generator)
    for name, p in module.named_parameters():
        if name.endswith("mix_factor"):
            p.fill_(0.5)
    return module


def init_unet384_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw ``UNet384``'s weights as the flax modules do; ``latent_conv_in``
    starts at zero, so the latent injection is a no-op at init."""
    _init_flax_(module, generator, zero=("latent_conv_in.",))
    return module


def init_offset_encoder_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the offset encoder's weights as the flax modules do; the last
    conv (``blocks.16``) starts at zero, so the offset is 0 at init."""
    last = max(int(n.split(".")[1]) for n, _ in module.named_parameters())
    _init_flax_(module, generator, zero=(f"blocks.{last}.",))
    return module


@torch.no_grad()
def init_clip_vision_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the CLIP vision tower's weights as the flax modules do: the
    class embedding N(0, 0.02²), the position table by ``nn.Embed``'s
    default N(0, 1/hidden), lecun-normal kernels (the patch conv's fan-in
    p·p·3), zero biases, unit LayerNorm scales."""
    for name, p in module.named_parameters():
        if name.endswith("class_embedding"):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=p.device))
        elif name.endswith("position_embedding.weight"):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                    / math.sqrt(p.shape[1]))
        elif name.endswith(".bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            _lecun_normal_(p, p[0].numel(), generator)
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


def _fourier_order(c2: int) -> np.ndarray:
    """JAX's grouped Fourier-unit channels (re…, im…) → the published
    interleaved ones (c0_re, c0_im, …): interleaved[i] = grouped[order[i]]
    (the inverse of JAX's ``_fourier_perm``)."""
    c = c2 // 2
    grouped = np.asarray([ci * 2 + ri for ri in (0, 1) for ci in range(c)])
    return np.argsort(grouped)


def lama_state_dict(params: Dict[str, Any], cfg=None) -> Dict[str, torch.Tensor]:
    """JAX ``LargeMaskInpainting`` params → the port's state dict in the
    published ``model.N.*`` layout (the inverse of JAX's
    ``import_lama_torch_state``): conv kernels HWIO → OIHW, the
    ConvTranspose kernel un-flipped with in/out swapped back, the Fourier
    units' grouped channels interleaved again, BatchNorm ``scale / bias /
    mean / var`` → ``weight / bias / running_mean / running_var`` (and a
    zero ``num_batches_tracked``)."""
    from animate_anything_tpu_torch.models.lama import LamaConfig

    cfg = cfg or LamaConfig()
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def put(key, w):
        out[key] = _to_torch(w)

    def conv(key, p):
        put(f"{key}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def bn(key, p, order=None):
        for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            v = np.asarray(p[src])
            put(f"{key}.{dst}", v if order is None else v[order])
        out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    def ffc_bn_act(key, p):
        ffc = p["ffc"]
        for name in ("convl2l", "convl2g", "convg2l"):
            if name in ffc:
                conv(f"{key}.ffc.{name}", ffc[name])
        if "convg2g" in ffc:
            st, sk = ffc["convg2g"], f"{key}.ffc.convg2g"
            conv(f"{sk}.conv1.0", st["conv1"])
            bn(f"{sk}.conv1.1", st["bn1"])
            w = np.asarray(st["fu"]["conv"]["kernel"])            # (1, 1, in2, out2)
            oi, oo = _fourier_order(w.shape[2]), _fourier_order(w.shape[3])
            put(f"{sk}.fu.conv_layer.weight", w[:, :, oi][:, :, :, oo].transpose(3, 2, 0, 1))
            bn(f"{sk}.fu.bn", st["fu"]["bn"], oo)
            conv(f"{sk}.conv2", st["conv2"])
        for name in ("bn_l", "bn_g"):
            if name in p:
                bn(f"{key}.{name}", p[name])

    idx, seq = 0, 1                     # model.0 is the reflection pad
    for _ in range(1 + cfg.n_downsampling):
        ffc_bn_act(f"model.{seq}", tree[f"model_{idx}"])
        idx += 1
        seq += 1
    for _ in range(cfg.n_blocks):
        for half in ("conv1", "conv2"):
            ffc_bn_act(f"model.{seq}.{half}", tree[f"model_{idx}"][half])
        idx += 1
        seq += 1
    seq += 1                            # ConcatTupleLayer
    for i in range(cfg.n_downsampling):
        k = np.asarray(tree[f"up_{i}_conv"]["kernel"])          # flipped HWIO
        put(f"model.{seq}.weight", k[::-1, ::-1].transpose(2, 3, 0, 1))
        put(f"model.{seq}.bias", tree[f"up_{i}_conv"]["bias"])
        bn(f"model.{seq + 1}", tree[f"up_{i}_bn"])
        seq += 3                        # ConvTranspose2d, BatchNorm2d, ReLU
    seq += 1                            # reflection pad
    conv(f"model.{seq}", tree["conv_out"])
    put(f"model.{seq}.bias", tree["conv_out"]["bias"])
    return out


@torch.no_grad()
def init_lama_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw LaMa's weights as the flax modules do (lecun-normal conv kernels,
    the ConvTranspose's fan-in in·kh·kw, zero biases, unit BatchNorm scales),
    then randomize every BatchNorm's running statistics (mean N(0, 0.1²),
    variance U(0.5, 1.5)) so the inference BatchNorms do real work."""
    dev = next(module.parameters()).device
    for m in module.modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            _lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(), generator)
        elif isinstance(m, torch.nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=generator,
                                                   device=dev))
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=generator,
                                                 device=dev))
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.BatchNorm2d)) \
                and m.bias is not None:
            m.bias.zero_()
    return module
