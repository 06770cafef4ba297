"""Device-time profile of the port's main path on one CUDA device.

    python -m animate_anything_tpu_torch.utils.profiling [--opt-in | --attn-impl IMPL]

Builds the full-width mask+motion UNet, the SD VAE and the CLIP text encoder
in bf16 from a seeded generator, as ``chip_smoke.py`` does, then profiles
one CFG UNet forward (batch 2 × (16 + 1) frames at 64×64 latents, one
denoise step), one 16-frame VAE decode, one text encode (a prompt and
the empty negative, 77 tokens each) and, last, one training step of the
flagship finetune (``train.mask_motion_finetune``: one 16-frame 512 px clip,
VAE encode and text inside the step, per-sub-layer checkpointing, AdamW on
fp32 masters) with ``torch.profiler``. For each it prints the wall time (the
median of three calls), the device kernel time, the device idle share (1 −
kernel time / wall time; one stream, so kernels do not overlap), the kernel
time by group, the largest kernels, and the host's self time in the
profiled call by operation (inflated by the profiler's own cost; read it as
shares). The last line is one JSON object with those numbers.

``--opt-in`` (``profile_opt_in``) profiles instead one CFG UNet forward and
one 16-frame VAE decode in the JAX package's opt-in GroupNorm and resnet-conv
configuration (``ops/spatial_conv.opt_in_config``), each beside the same call
in the default configuration. Kernel 7's two sum passes are the
``channel_partial``/``channel_finish`` kernels, so they count in kernel 6's
group.

``--attn-impl packed`` (or ``xla``; ``profile_attn_impl``) profiles one CFG
UNet forward with the same weights under ``UNet3DConfig(attn_impl=IMPL)``,
beside the same forward in the default ``"pallas"`` configuration.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Callable, Dict

import torch

# Kernel name → group; the first group with a matching substring wins.
KERNEL_GROUPS = (
    ("SDPA (library)", ("pytorch_flash", "fmha", "efficient_attention", "sdpa")),
    ("flash_attention (kernel 1)", ("flash_fwd",)),
    ("flash_attention backward", ("flash_bwd",)),
    ("ln_geglu (kernel 2)", ("ln_geglu",)),
    ("tap_conv (kernel 3)", ("tap_conv",)),
    ("proj_residual (kernel 4)", ("proj_residual",)),
    ("temporal_block (kernel 5)", ("temporal_block",)),
    ("channel_sums (kernel 6)", ("channel_partial", "channel_finish")),
    ("group_norm_stream (kernel 7)", ("group_fold", "gn_apply")),
    ("spatial_conv (kernel 8)", ("spatial_conv",)),
    ("temporal_attention (kernel 9)", ("temporal_attention",)),
    ("ln_qkv (kernel 11)", ("ln_qkv",)),
    ("conv (cuDNN)", ("conv", "fprop", "implicit", "cudnn", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas", "matmul", "bmm", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "memcpy", "index", "gather", "repeat")),
    ("optimizer (foreach)", ("multi_tensor",)),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for tag, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return tag
    return "elementwise/other"


def device_profile(fn: Callable[[], object]) -> Dict:
    """After two warm-up calls: the median wall ms of three calls of ``fn``
    (each ended by a device sync), then one profiled call's device
    kernels and host operations: ``{"wall_ms", "walls_ms", "kernel_ms",
    "idle_share", "groups": {group: ms}, "kernels": [[ms, calls, name],
    ...], "host_ms", "host_ops": [[ms, calls, name], ...]}``, the kernels
    and the host operations (self time) largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    fn()
    sync()
    walls_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        sync()
        walls_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls_ms)[len(walls_ms) // 2]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        sync()
    kernels, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            host.append([e.self_cpu_time_total / 1e3, e.count, e.key])
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
    host.sort(reverse=True)
    return dict(wall_ms=wall_ms, walls_ms=walls_ms, kernel_ms=kernel_ms,
                idle_share=max(0.0, 1.0 - kernel_ms / wall_ms),
                groups=dict(groups.most_common()), kernels=kernels,
                host_ms=sum(h[0] for h in host), host_ops=host)


def _report(name: str, prof: Dict) -> None:
    total = prof["kernel_ms"]
    walls = ", ".join(f"{w:.1f}" for w in prof["walls_ms"])
    print(f"== {name}: wall {prof['wall_ms']:.1f} ms ({walls}), device kernel time "
          f"{total:.1f} ms, idle share {prof['idle_share']:.3f}, host self time "
          f"{prof['host_ms']:.1f} ms (profiled)", flush=True)
    for group, ms in prof["groups"].items():
        print(f"   {group:28s} {ms:9.2f} ms  {100 * ms / total:5.1f}%")
    for ms, calls, kname in prof["kernels"][:20]:
        print(f"   {ms:9.2f} ms  x{calls:5d}  {kname[:110]}")
    for ms, calls, hname in prof["host_ops"][:12]:
        print(f"   host {ms:9.2f} ms  x{calls:5d}  {hname[:100]}")


def _report_all(profiles) -> None:
    """Print each ``(name, fn)``'s profile, then all of them as one JSON line."""
    out = {}
    for name, fn in profiles:
        out[name] = device_profile(fn)
        _report(name, out[name])
        for key in ("kernels", "host_ops"):
            out[name][key] = [[ms, calls, kname[:120]]
                              for ms, calls, kname in out[name][key][:20]]
    print(json.dumps(out))


def _inference_setup(seed: int, gradient_checkpointing: bool):
    """The full-width UNet, VAE and CLIP text encoder in bf16, and the CFG
    UNet forward, 16-frame VAE decode and text encode to profile."""
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
        # checkpointing acts only while autograd records: the inference
        # profiles run under no_grad and are unaffected
        unet = UNet3DConditionModel(UNet3DConfig(motion_mask=True, motion_strength=True,
                                                 gradient_checkpointing=gradient_checkpointing))
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

    return unet, vae, text, ids, gen, unet_forward, vae_decode, text_encode


def profile_opt_in(seed: int = 0) -> int:
    """One CFG UNet forward and one 16-frame VAE decode in the opt-in
    configuration, each after the same call in the default one."""
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (torch.cuda.is_available() is False)")
    from animate_anything_tpu_torch.ops.spatial_conv import opt_in_config

    *_, unet_forward, vae_decode, _ = _inference_setup(seed, gradient_checkpointing=False)

    def opt_in(fn):
        def run():
            with opt_in_config():
                return fn()
        return run

    _report_all((("unet_cfg_forward", unet_forward),
                 ("unet_cfg_forward_opt_in", opt_in(unet_forward)),
                 ("vae_decode_16f", vae_decode), ("vae_decode_16f_opt_in", opt_in(vae_decode))))
    return 0


def profile_attn_impl(impl: str, seed: int = 0) -> int:
    """One CFG UNet forward under ``attn_impl=impl`` (the same weights),
    after the same forward in the default configuration."""
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (torch.cuda.is_available() is False)")
    unet, *_, unet_forward, _, _ = _inference_setup(seed, gradient_checkpointing=False)
    other = unet.with_attn_impl(impl)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, 16, 64, 64, 4, generator=gen, device="cuda")
    cond = torch.randn(2, 1, 64, 64, 4, generator=gen, device="cuda").to(torch.bfloat16)
    mask = (torch.rand(2, 1, 64, 64, 1, generator=gen, device="cuda") > 0.5).float()
    emb = torch.randn(2, 77, 1024, generator=gen, device="cuda")
    motion = torch.tensor([5.0, 5.0], device="cuda")

    @torch.no_grad()
    def other_forward():
        return other(x, 500, emb, cond, mask, motion)

    _report_all((("unet_cfg_forward", unet_forward), (f"unet_cfg_forward_{impl}", other_forward)))
    return 0


def main(seed: int = 0) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (torch.cuda.is_available() is False)")
    from animate_anything_tpu_torch.train import (create_train_state, make_train_step,
                                                  mask_motion_finetune)

    unet, vae, text, ids, gen, unet_forward, vae_decode, text_encode = _inference_setup(
        seed, gradient_checkpointing=True)
    pixels = torch.rand(1, 16, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
    train_mask = torch.zeros(1, 512, 512, device="cuda")
    train_mask[:, 128:384] = 255.0
    batch = {"pixel_values": pixels, "mask": train_mask, "prompt_ids": ids[:1],
             "uncond_ids": ids[1:]}
    config, schedule = mask_motion_finetune()
    vae.requires_grad_(False)
    text.requires_grad_(False)
    state = create_train_state(unet, config)
    step = make_train_step(schedule, config, vae=vae, text_encoder=text)
    train_gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def train_step():
        return step(state, batch, train_gen)

    _report_all((("unet_cfg_forward", unet_forward), ("vae_decode_16f", vae_decode),
                 ("clip_text_encode_2x77", text_encode), ("train_step_16f_512px", train_step)))
    return 0


if __name__ == "__main__":
    import sys

    argv = sys.argv[1:]
    if "--attn-impl" in argv:
        raise SystemExit(profile_attn_impl(argv[argv.index("--attn-impl") + 1]))
    raise SystemExit(profile_opt_in() if "--opt-in" in argv else main())
