"""Device-time profile of the port's main path on one CUDA device.

    python -m animate_anything_tpu_torch.utils.profiling [--opt-in | --attn-impl IMPL | --svd]

Builds the full-width mask+motion UNet, the SD VAE and the CLIP text encoder
in bf16 from a seeded generator, as ``chip_smoke.py`` does, then profiles
one CFG UNet forward (batch 2 × (16 + 1) frames at 64×64 latents, one
denoise step), one 16-frame VAE decode, one text encode (a prompt and
the empty negative, 77 tokens each) and, last, one training step of the
flagship finetune (``train.mask_motion_finetune``: one 16-frame 512 px clip,
VAE encode and text inside the step, per-sub-layer checkpointing, AdamW on
fp32 masters) with ``torch.profiler``. For each it prints the wall time (the
median of three calls), the device kernel time, the device idle share of the
profiled call (1 − the union of its device operations' intervals over the
call's own interval in the trace), the kernel time by group, the largest
kernels, the port's spans (``utils/tracing.py``: each ``aat.*`` name's
count, the device time launched inside it and the device's idle time
inside it), and the host's self time in the profiled call by operation
(inflated by the profiler's own cost; read it as shares). The first line is
the card's name and power limit, the last one JSON object with those
numbers.

``--opt-in`` (``profile_opt_in``) profiles instead one CFG UNet forward and
one 16-frame VAE decode in the JAX package's opt-in GroupNorm and resnet-conv
configuration (``ops/spatial_conv.opt_in_config``), each beside the same call
in the default configuration.

``--attn-impl packed`` (or ``xla``; ``profile_attn_impl``) profiles one CFG
UNet forward with the same weights under ``UNet3DConfig(attn_impl=IMPL)``,
beside the same forward in the default ``"pallas"`` configuration.

``--svd`` (``profile_svd``) profiles the SVD serving path instead, as
``cli_svd.build_svd_models`` builds it for ``configs/train_svd_mask.yaml``
(9 channels, ``attn_impl="pallas"``, bf16, seeded random weights): one CFG
forward of the spatio-temporal UNet (batch 2 × 14 frames at 64×64 latents,
the first profile of the process), one 14-frame VAE decode in chunks of 7
and one CLIP vision encode.
"""

from __future__ import annotations

import bisect
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
    ("channel_sums (kernel 6)", ("channel_sums",)),
    ("group_norm_stream (kernel 7)", ("gn_stream",)),
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


CALL = "device_profile.call"   # the profiler range around the profiled call


def _union(intervals) -> list:
    """Sorted, merged [start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two unions of intervals."""
    total, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


def trace_spans(events, window: str = CALL) -> Dict:
    """From a profile's kineto events: the ``window`` range's idle share of
    the device (1 − the union of the device operations' intervals inside it
    over its length; 1.0 where no device operation ran) and, for each
    ``aat.*`` span name, ``{"count", "device_ms", "idle_ms"}``: its ranges,
    the device time of the operations launched while the host was inside
    one of them, and the time inside them (in the window) that the device
    sat idle."""
    spans, device, launch, win = {}, [], {}, None
    for e in events:
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if str(e.device_type()).endswith("CPU"):
            if e.is_user_annotation():
                if name == window:
                    win = (start, end)
                elif name.startswith("aat."):
                    spans.setdefault(name, []).append((start, end))
            elif name.startswith("cu"):          # a runtime or driver call
                launch[e.correlation_id()] = start
        elif not e.is_user_annotation():
            device.append((start, end, e.correlation_id()))
    if win is None:
        return {"idle_share": None, "spans": {}}
    lo, hi = win
    busy = _union((max(s, lo), min(e, hi)) for s, e, _ in device if e > lo and s < hi)
    table = {}
    for name, ranges in sorted(spans.items()):
        inner = _union(ranges)
        starts = [a for a, _ in inner]
        launched = 0
        for s, e, corr in device:
            t = launch.get(corr)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < inner[i][1]:
                launched += e - s
        in_window = _union((max(s, lo), min(e, hi)) for s, e in inner if e > lo and s < hi)
        idle = sum(e - s for s, e in in_window) - _overlap_ns(in_window, busy)
        table[name] = {"count": len(ranges), "device_ms": launched / 1e6, "idle_ms": idle / 1e6}
    covered = sum(e - s for s, e in busy)
    return {"idle_share": 1.0 - covered / (hi - lo) if hi > lo else None, "spans": table}


def device_profile(fn: Callable[[], object]) -> Dict:
    """After two warm-up calls: the median wall ms of three calls of ``fn``
    (each ended by a device sync), then one profiled call's device
    kernels, spans and host operations: ``{"wall_ms", "walls_ms",
    "kernel_ms", "idle_share", "groups": {group: ms}, "group_kernels":
    {group: kernels run}, "kernels": [[ms, calls, name], ...], "spans":
    {name: {"count", "device_ms", "idle_ms"}}, "host_ms", "host_ops": [[ms,
    calls, name], ...]}``, the kernels and the host operations (self time)
    largest first; ``idle_share`` and ``spans`` as ``trace_spans`` reads
    them from the profiled call. On the H100 machine (torch 2.11, CUDA
    12.8) a process that has run for some tens of seconds loses the device
    records of most profiles, whole: there ``kernels`` can come back empty
    or short, and ``idle_share`` too high."""
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
        with torch.autograd.profiler.record_function(CALL):
            fn()
            sync()
    kernels, host = [], []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False) or e.key == CALL or e.key.startswith("aat."):
            continue     # ranges, not operations: on the device each spans kernels counted
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
    groups, runs = collections.Counter(), collections.Counter()
    for ms, calls, name in kernels:
        groups[kernel_group(name)] += ms
        runs[kernel_group(name)] += calls
    host.sort(reverse=True)
    traced = trace_spans(prof.profiler.kineto_results.events())
    return dict(wall_ms=wall_ms, walls_ms=walls_ms, kernel_ms=kernel_ms,
                idle_share=traced["idle_share"], groups=dict(groups.most_common()),
                group_kernels={g: runs[g] for g, _ in groups.most_common()}, kernels=kernels,
                spans=traced["spans"], host_ms=sum(h[0] for h in host), host_ops=host)


def _report(name: str, prof: Dict) -> None:
    total = prof["kernel_ms"]
    walls = ", ".join(f"{w:.1f}" for w in prof["walls_ms"])
    print(f"== {name}: wall {prof['wall_ms']:.1f} ms ({walls}), device kernel time "
          f"{total:.1f} ms, idle share {prof['idle_share']:.3f}, host self time "
          f"{prof['host_ms']:.1f} ms (profiled)", flush=True)
    for group, ms in prof["groups"].items():
        print(f"   {group:28s} {ms:9.2f} ms  {100 * ms / total:5.1f}%  "
              f"{prof['group_kernels'][group]:6d} kernels")
    for ms, calls, kname in prof["kernels"][:20]:
        print(f"   {ms:9.2f} ms  x{calls:5d}  {kname[:110]}")
    for sname, row in prof["spans"].items():
        print(f"   span {sname:28s} x{row['count']:5d}  device {row['device_ms']:9.2f} ms  "
              f"idle {row['idle_ms']:9.2f} ms")
    for ms, calls, hname in prof["host_ops"][:12]:
        print(f"   host {ms:9.2f} ms  x{calls:5d}  {hname[:100]}")


def _report_all(profiles) -> None:
    """Print the card's name and power limit, each ``(name, fn)``'s profile,
    then all of them as one JSON line."""
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
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
                                                 attn_impl="pallas",
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


def profile_svd(seed: int = 0) -> int:
    """One SVD CFG UNet forward, one 14-frame VAE decode (chunks of 7) and
    one CLIP vision encode at the full-width SVD configuration."""
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (torch.cuda.is_available() is False)")
    from animate_anything_tpu_torch.cli_svd import build_svd_models
    from animate_anything_tpu_torch.models.vae import decode_video

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = build_svd_models(motion_mask=True, compute_dtype=torch.bfloat16, seed=seed,
                         attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, 14, 64, 64, 9, generator=gen, device="cuda")
    emb = torch.randn(2, 1, 1024, generator=gen, device="cuda")
    emb[0] = 0.0
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device="cuda")
    t = torch.tensor(0.25 * 2.302585, device="cuda")
    z = torch.randn(1, 14, 64, 64, 4, generator=gen, device="cuda")
    px = torch.randn(1, 224, 224, 3, generator=gen, device="cuda")

    @torch.no_grad()
    def unet_forward():
        return m["unet"](x, t, emb, ids)

    @torch.no_grad()
    def vae_decode():
        return decode_video(m["vae"], z, chunk_size=7)

    @torch.no_grad()
    def clip_encode():
        return m["image_encoder"](px)

    _report_all((("svd_unet_cfg_forward_14f", unet_forward), ("vae_decode_14f_chunk7", vae_decode),
                 ("clip_vision_encode_1x224", clip_encode)))
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
    if "--svd" in argv:
        raise SystemExit(profile_svd())
    raise SystemExit(profile_opt_in() if "--opt-in" in argv else main())
