"""Device-time profile of the port's main path on one CUDA device.

    python -m animate_anything_tpu_torch.utils.profiling

Builds the full-width mask+motion UNet, the SD VAE and the CLIP text encoder
in bf16 from a seeded generator, as ``chip_smoke.py`` does, then profiles
one CFG UNet forward (batch 2 × (16 + 1) frames at 64×64 latents, one
denoise step), one 16-frame VAE decode and one text encode (a prompt and
the empty negative, 77 tokens each) with ``torch.profiler``. For each it prints the wall
time, the device kernel time, the device idle share (1 − kernel time / wall
time; one stream, so kernels do not overlap), the kernel time by group, and
the largest kernels. The last line is one JSON object with those numbers.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Callable, Dict

import torch

# Kernel name → group; the first group with a matching substring wins.
KERNEL_GROUPS = (
    ("flash_attention (kernel 1)", ("flash_fwd",)),
    ("ln_geglu (kernel 2)", ("ln_geglu",)),
    ("tap_conv (kernel 3)", ("tap_conv",)),
    ("proj_residual (kernel 4)", ("proj_residual",)),
    ("temporal_block (kernel 5)", ("temporal_block",)),
    ("conv (cuDNN)", ("conv", "fprop", "implicit", "cudnn", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas", "matmul", "bmm", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "memcpy", "index", "gather", "repeat")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for tag, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return tag
    return "elementwise/other"


def device_profile(fn: Callable[[], object]) -> Dict:
    """After two warm-up calls: wall ms of one call of ``fn`` (ended by a
    device sync), then one profiled call's device kernels: ``{"wall_ms",
    "kernel_ms", "idle_share", "groups": {group: ms}, "kernels": [[ms,
    calls, name], ...]}``, the kernels largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        sync()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append([us / 1e3, e.count, e.key])
    kernels.sort(reverse=True)
    kernel_ms = sum(k[0] for k in kernels)
    groups = collections.Counter()
    for ms, _, name in kernels:
        groups[kernel_group(name)] += ms
    return dict(wall_ms=wall_ms, kernel_ms=kernel_ms,
                idle_share=max(0.0, 1.0 - kernel_ms / wall_ms),
                groups=dict(groups.most_common()), kernels=kernels)


def _report(name: str, prof: Dict) -> None:
    total = prof["kernel_ms"]
    print(f"== {name}: wall {prof['wall_ms']:.1f} ms, device kernel time {total:.1f} ms, "
          f"idle share {prof['idle_share']:.3f}", flush=True)
    for group, ms in prof["groups"].items():
        print(f"   {group:28s} {ms:9.2f} ms  {100 * ms / total:5.1f}%")
    for ms, calls, kname in prof["kernels"][:20]:
        print(f"   {ms:9.2f} ms  x{calls:5d}  {kname[:110]}")


def main(seed: int = 0) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (torch.cuda.is_available() is False)")
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig, decode_video
    from animate_anything_tpu_torch.utils.convert import init_clip_text_, init_unet3d_, init_vae_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        unet = UNet3DConditionModel(UNet3DConfig(motion_mask=True, motion_strength=True))
        vae = AutoencoderKL(VAEConfig())
    cast_module_(init_unet3d_(unet, gen)).eval()
    cast_module_(init_vae_(vae, gen)).eval()
    with torch.device("cuda"):
        text = CLIPTextModel()
    cast_module_(init_clip_text_(text, gen)).eval()
    ids = torch.as_tensor(HashTokenizer()(["a red ball rolls across a wooden table", ""],
                                          padding="max_length").input_ids, device="cuda")

    x = torch.randn(2, 16, 64, 64, 4, generator=gen, device="cuda")
    cond = torch.randn(2, 1, 64, 64, 4, generator=gen, device="cuda").to(torch.bfloat16)
    mask = (torch.rand(2, 1, 64, 64, 1, generator=gen, device="cuda") > 0.5).float()
    emb = torch.randn(2, 77, 1024, generator=gen, device="cuda")
    motion = torch.tensor([5.0, 5.0], device="cuda")

    @torch.no_grad()
    def unet_forward():
        return unet(x, 500, emb, cond, mask, motion)

    @torch.no_grad()
    def vae_decode():
        return decode_video(vae, x[:1])

    @torch.no_grad()
    def text_encode():
        return text(ids)

    out = {}
    for name, fn in (("unet_cfg_forward", unet_forward), ("vae_decode_16f", vae_decode),
                     ("clip_text_encode_2x77", text_encode)):
        out[name] = device_profile(fn)
        _report(name, out[name])
        out[name]["kernels"] = out[name]["kernels"][:20]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
