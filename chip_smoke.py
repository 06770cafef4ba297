#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the torch/CUDA versions and the card's name and power limit;
2. builds the hand-written Hopper kernels from ``animate_anything_tpu_torch/csrc``;
3. checks each kernel against its plain PyTorch version at the main path's
   shapes (bf16 inputs; the plain version computes in fp32 on the same
   inputs) and times both with CUDA events; times one temporal transformer
   per width on its fused path (kernel 5 + kernel 2) against the composite
   path;
4. runs a small UNet on the card through the kernels (every temporal site on
   the fused path) and holds it against the same weights through the plain
   versions on the CPU;
5. builds the full-width mask+motion UNet, the SD VAE and the CLIP text
   encoder in bf16 from a seeded generator and answers two 512x512 /
   16-frame image-to-video requests, each an image and a prompt string
   (hash tokenizer), through ``LatentToVideoPipeline.animate_image`` (CFG 9,
   DPM-Solver++);
6. checks that every kernel was launched during the requests, prints one JSON
   line with the kernels' numbers, and last the device line.

Exits non-zero without a CUDA device, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# Tolerances of kernel vs plain version, both on the same bf16 inputs.
# Outputs: bf16 rounding of the stored result (2^-8 relative) plus fp32
# accumulation-order noise.
Y_ATOL, Y_RTOL = 2e-2, 1e-2
# Σy / Σy² epilogues: fp32 atomics sum in another order, and a different
# accumulation order can flip a bf16 rounding of y by one ulp (≤ 2^-7·|y|)
# at a few of the s rows of a column.
SUM_ATOL, SUM_RTOL = 0.5, 1e-3
# The sums must be those of the STORED bf16 y, which the consumer GroupNorm
# normalises: each is held against the sum of the kernel's own output, where
# only the fp32 summation order differs (~1e-4 at s = 4096). Sums of the
# unrounded fp32 y would be off by ~0.1 in Σy there.
STORED_SUM_ATOL, STORED_SUM_RTOL = 1e-2, 2e-5

STEPS = 25
REQUESTS = 2
FRAMES = 16
RES = 512
GUIDANCE = 9.0
PROMPTS = ("a red ball rolls across a wooden table", "clouds drift over a mountain lake")
# The full-width temporal sites: (locations h·w, width c) at f = 17, b = 2
# (CFG); heads = c / 64. (4096, 512) is transformer_in (8 heads x 64 on 320
# channels).
TEMPORAL_SITES = ((4096, 512), (4096, 320), (1024, 640), (256, 1280), (64, 1280))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Mean milliseconds per call of fn on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _assert_stored_sums(name: str, y, sums, dim: int) -> None:
    yf = y.float()
    _assert_close(name + " Σy of stored y", sums[0], yf.sum(dim),
                  STORED_SUM_ATOL, STORED_SUM_RTOL)
    _assert_close(name + " Σy² of stored y", sums[1], yf.square().sum(dim),
                  STORED_SUM_ATOL, STORED_SUM_RTOL)


def _assert_close(name: str, got, want, atol: float, rtol: float) -> None:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol={atol} "
                             f"rtol={rtol}; max |err| {_err(got, want):.4g}")


def _lecun(gen, *shape, fan_in: int, dev="cuda"):
    w = torch.randn(*shape, generator=gen, device=dev) / fan_in ** 0.5
    return w.to(torch.bfloat16)


def check_flash(gen) -> dict:
    from animate_anything_tpu_torch.ops import flash_attention as fa

    total_ms = total_plain = max_err = 0.0
    for s, h in ((4096, 5), (1024, 10), (256, 20)):
        b, d = 2 * (FRAMES + 1), 64
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        sl = slice(0, 2)  # plain fp32 scores for all 34 x h heads would not fit
        got = fa.flash_attention(q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous())
        want = fa.attention_reference(q[sl], k[sl], v[sl])
        _assert_close(f"flash s={s}", got, want, Y_ATOL, Y_RTOL)
        err = _err(got, want)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        plain = cuda_ms(lambda: [fa.attention_reference(q[i:i + 2], k[i:i + 2], v[i:i + 2])
                                 for i in range(0, b, 2)], warmup=1, iters=2)
        tflops = 4 * b * h * s * s * d / (ms * 1e-3) / 1e12
        log(f"  flash_attention b={b} s={s} h={h} d={d}: max|err| {err:.3g}  "
            f"kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s)  plain {plain:.3f} ms")
        total_ms, total_plain, max_err = total_ms + ms, total_plain + plain, max(max_err, err)
    return dict(name="flash_attention", route="cuda",
                source="animate_anything_tpu_torch/csrc/flash_attention.cu",
                replaces="animate_anything_tpu/ops/flash_attention.py:190",
                max_abs_err=max_err, ms=total_ms, plain_ms=total_plain)


def check_geglu(gen) -> dict:
    from animate_anything_tpu_torch.ops import geglu

    total_ms = total_plain = max_err = 0.0
    for n, c in ((34 * 4096, 320), (34 * 4096, 512), (34 * 1024, 640), (34 * 256, 1280),
                 (34 * 64, 1280)):
        x = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
        s = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        w1 = _lecun(gen, 8 * c, c, fan_in=c)
        b1 = 0.1 * torch.randn(8 * c, generator=gen, device="cuda")
        w2 = _lecun(gen, c, 4 * c, fan_in=4 * c)
        b2 = 0.1 * torch.randn(c, generator=gen, device="cuda")
        got = geglu.ln_geglu_ff(x, s, b, w1, b1, w2, b2)
        want = geglu.ln_geglu_reference(x, s, b, w1, b1, w2, b2, 1e-5)
        _assert_close(f"ln_geglu n={n} c={c}", got, want, Y_ATOL, Y_RTOL)
        err = _err(got, want)
        ms = cuda_ms(lambda: geglu.ln_geglu_ff(x, s, b, w1, b1, w2, b2))
        plain = cuda_ms(lambda: geglu.ln_geglu_reference(x, s, b, w1, b1, w2, b2, 1e-5),
                        warmup=1, iters=3)
        log(f"  ln_geglu_ff n={n} c={c}: max|err| {err:.3g}  kernel {ms:.3f} ms  "
            f"plain {plain:.3f} ms")
        total_ms, total_plain, max_err = total_ms + ms, total_plain + plain, max(max_err, err)
    return dict(name="ln_geglu_ff", route="cuda", source="animate_anything_tpu_torch/csrc/geglu.cu",
                replaces="animate_anything_tpu/ops/geglu.py:109",
                max_abs_err=max_err, ms=total_ms, plain_ms=total_plain)


def check_tap_conv(gen) -> dict:
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    total_ms = total_plain = max_err = 0.0
    bsz, f = 2, FRAMES + 1
    for s, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        x = torch.randn(bsz, f, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        a = 1.0 + 0.1 * torch.randn(bsz, c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(bsz, c, generator=gen, device="cuda")
        w = _lecun(gen, c, 3, c, fan_in=3 * c)
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        res = torch.randn(bsz, f, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        for residual in (None, res):
            y, (s1, s2) = tc.tap_conv(x, a, b, w, bias, residual)
            wy, (w1, w2) = tc.tap_conv_reference(x, a, b, w, bias, residual)
            tag = f"tap_conv s={s} c={c} residual={residual is not None}"
            _assert_close(tag, y, wy, Y_ATOL, Y_RTOL)
            _assert_close(tag + " Σy", s1, w1, SUM_ATOL, SUM_RTOL)
            _assert_close(tag + " Σy²", s2, w2, SUM_ATOL, SUM_RTOL)
            _assert_stored_sums(tag, y, (s1, s2), dim=2)
            max_err = max(max_err, _err(y, wy))
        ms = cuda_ms(lambda: tc.tap_conv(x, a, b, w, bias, res))
        plain = cuda_ms(lambda: tc.tap_conv_reference(x, a, b, w, bias, res), warmup=1, iters=3)
        log(f"  tap_conv bsz={bsz} f={f} s={s} c={c}: max|err| {max_err:.3g}  "
            f"kernel {ms:.3f} ms  plain {plain:.3f} ms")
        total_ms, total_plain = total_ms + ms, total_plain + plain
    return dict(name="tap_conv", route="cuda",
                source="animate_anything_tpu_torch/csrc/temporal_conv.cu",
                replaces="animate_anything_tpu/ops/temporal_conv.py:114",
                max_abs_err=max_err, ms=total_ms, plain_ms=total_plain)


def check_proj_residual(gen) -> dict:
    from animate_anything_tpu_torch.ops import proj_residual as pr

    total_ms = total_plain = max_err = 0.0
    n = 2 * (FRAMES + 1)
    for s, k, c in ((4096, 512, 320), (4096, 320, 320), (1024, 640, 640), (256, 1280, 1280),
                    (64, 1280, 1280)):
        h = torch.randn(n, s, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = _lecun(gen, c, k, fan_in=k)
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        r = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        y, (s1, s2) = pr.proj_residual_stats(h, w, bias, r)
        wy, (w1, w2) = pr.proj_residual_reference(h, w, bias, r)
        tag = f"proj_residual n={n} s={s} k={k} c={c}"
        _assert_close(tag, y, wy, Y_ATOL, Y_RTOL)
        _assert_close(tag + " Σy", s1, w1, SUM_ATOL, SUM_RTOL)
        _assert_close(tag + " Σy²", s2, w2, SUM_ATOL, SUM_RTOL)
        _assert_stored_sums(tag, y, (s1, s2), dim=1)
        err = _err(y, wy)
        ms = cuda_ms(lambda: pr.proj_residual_stats(h, w, bias, r))
        plain = cuda_ms(lambda: pr.proj_residual_reference(h, w, bias, r), warmup=1, iters=3)
        log(f"  {tag}: max|err| {err:.3g}  kernel {ms:.3f} ms  plain {plain:.3f} ms")
        total_ms, total_plain, max_err = total_ms + ms, total_plain + plain, max(max_err, err)
    return dict(name="proj_residual_stats", route="cuda",
                source="animate_anything_tpu_torch/csrc/proj_residual.cu",
                replaces="animate_anything_tpu/ops/proj_residual.py:80",
                max_abs_err=max_err, ms=total_ms, plain_ms=total_plain)


def check_temporal_block(gen) -> dict:
    from animate_anything_tpu_torch.ops import temporal_block as tb

    total_ms = total_plain = max_err = 0.0
    b, f = 2, FRAMES + 1
    for s, c in TEMPORAL_SITES:
        heads = c // 64
        x = torch.randn(b, f, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        ln_s = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        ln_b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        ws = [_lecun(gen, c, c, fan_in=c) for _ in range(4)]
        bo = 0.1 * torch.randn(c, generator=gen, device="cuda")
        args = (x, ln_s, ln_b, *ws, bo)
        got = tb.temporal_block(*args, heads=heads)
        want = tb.temporal_block_reference(*args, heads=heads)
        tag = f"temporal_block b={b} f={f} s={s} c={c} heads={heads}"
        _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
        err = _err(got, want)
        ms = cuda_ms(lambda: tb.temporal_block(*args, heads=heads))
        plain = cuda_ms(lambda: tb.temporal_block_reference(*args, heads=heads), warmup=1,
                        iters=3)
        log(f"  {tag}: max|err| {err:.3g}  kernel {ms:.3f} ms  plain {plain:.3f} ms")
        total_ms, total_plain, max_err = total_ms + ms, total_plain + plain, max(max_err, err)
    return dict(name="temporal_block", route="cuda",
                source="animate_anything_tpu_torch/csrc/temporal_block.cu",
                replaces="animate_anything_tpu/ops/temporal_block.py:399",
                max_abs_err=max_err, ms=total_ms, plain_ms=total_plain)


KERNEL_CHECKS = (check_flash, check_geglu, check_tap_conv, check_proj_residual,
                 check_temporal_block)


def check_kernels(seed: int = 0) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for check in KERNEL_CHECKS:
        rows.append(check(gen))
        torch.cuda.empty_cache()
    return rows


def kernel_modules() -> dict:
    from animate_anything_tpu_torch.ops import (flash_attention, geglu, proj_residual,
                                                temporal_block, temporal_conv)

    return {"flash_attention": flash_attention, "ln_geglu_ff": geglu,
            "tap_conv": temporal_conv, "proj_residual_stats": proj_residual,
            "temporal_block": temporal_block}


def time_temporal_paths(seed: int = 0) -> None:
    """One full-width temporal transformer per site, bf16: its forward on the
    fused path (what the gate picks) against the composite path (the gate
    forced off: plain frame attention, exact-erf feed-forward)."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models import attention
    from animate_anything_tpu_torch.models.attention import TemporalTransformer
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gate = attention.fused_ok
    for s, c in TEMPORAL_SITES:
        channels, heads = (320, 8) if c == 512 else (c, c // 64)
        with torch.device("cuda"):
            tt = TemporalTransformer(channels, heads, 64)
        cast_module_(init_unet3d_(tt, gen)).eval()
        hw = int(s ** 0.5)
        x = torch.randn(2 * (FRAMES + 1), hw, hw, channels, generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            fused = cuda_ms(lambda: tt(x, FRAMES + 1))
            attention.fused_ok = lambda *a, **k: False
            try:
                composite = cuda_ms(lambda: tt(x, FRAMES + 1))
            finally:
                attention.fused_ok = gate
        log(f"  temporal transformer s={s} channels={channels} inner={heads * 64}: "
            f"fused {fused:.3f} ms  composite {composite:.3f} ms")


# A small UNet whose every kernel site is kernel-eligible (head dim 32, 16x16
# latents so the spatial self-attention runs flash at s = 256): its bf16
# forward on the card, through the kernels, is held against the same weights
# in fp32 on the CPU through the plain versions. Tolerance: relative RMS
# error of bf16 storage accumulated over ~40 layers.
SMALL_REL_RMS = 5e-2


def check_small_unet(seed: int = 0) -> float:
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True, attention_head_dim=32)
    ref = UNet3DConditionModel(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_unet3d_(ref, gen)
    for name, p in ref.named_parameters():   # wake the zero-initialised convs
        if "conv4.3" in name:
            p.data.normal_(0.0, 0.02, generator=gen)
    b, f, hw = 2, 3, 16
    sample = torch.randn(b, f, hw, hw, 4, generator=gen)
    cond = torch.randn(b, 1, hw, hw, 4, generator=gen)
    mask = (torch.rand(b, 1, hw, hw, 1, generator=gen) > 0.5).float()
    ctx = torch.randn(b, 77, cfg.cross_attention_dim, generator=gen)
    motion = torch.tensor([3.0, 7.0])
    with torch.no_grad():
        want = ref(sample, 500, ctx, cond, mask, motion)
        gpu = cast_module_(ref.to("cuda"))
        mods = kernel_modules()
        for mod in mods.values():
            mod.launches = 0
        got = gpu(sample.cuda(), 500, ctx.cuda(), cond.cuda(), mask.cuda(),
                  motion.cuda()).float().cpu()
    launches = {name: mod.launches for name, mod in mods.items()}
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"small UNet: kernels never launched: {missing}")
    if not torch.isfinite(got).all():
        raise AssertionError("small UNet: non-finite output on the card")
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    log(f"small UNet forward, card (kernels, bf16) vs CPU (plain, fp32): relative RMS {rel:.4g}"
        f" (limit {SMALL_REL_RMS}); launches {launches}")
    if rel > SMALL_REL_RMS:
        raise AssertionError(f"small UNet disagrees with its CPU reference: {rel:.4g}")
    return rel


def build_pipeline(seed: int = 0):
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import init_clip_text_, init_unet3d_, init_vae_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        unet = UNet3DConditionModel(UNet3DConfig(motion_mask=True, motion_strength=True))
        vae = AutoencoderKL(VAEConfig())
        text = CLIPTextModel()
    for module, init in ((unet, init_unet3d_), (vae, init_vae_), (text, init_clip_text_)):
        cast_module_(init(module, gen)).eval()
    count = lambda m: sum(p.numel() for p in m.parameters())
    log(f"unet: {count(unet) / 1e9:.3f} B params, vae: {count(vae) / 1e6:.1f} M, "
        f"CLIP text: {count(text) / 1e6:.1f} M (bf16 weights)")
    return LatentToVideoPipeline(unet, vae, text_encoder=text, tokenizer=HashTokenizer())


def make_requests(seed: int = 0) -> list[dict]:
    """Two image-to-video requests: image, motion mask, strength, prompt —
    each its own."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = []
    for prompt in PROMPTS[:REQUESTS]:
        image = rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
        mask = np.zeros((RES, RES), np.uint8)
        y0, x0 = rng.integers(0, RES // 2, 2)
        mask[y0:y0 + RES // 2, x0:x0 + RES // 2] = 255
        reqs.append(dict(image=image, prompt=prompt, mask_img=mask,
                         motion_strength=float(rng.uniform(2.0, 10.0))))
    return reqs


def run_requests() -> dict:
    """Drive the main path; return each kernel's launch count during it."""
    pipe = build_pipeline()
    reqs = make_requests()
    mods = kernel_modules()
    log(f"requests: {REQUESTS} x animate_image({RES}x{RES}, {FRAMES} frames, "
        f"{STEPS} DPM-Solver++ steps, CFG {GUIDANCE})")
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    for i, req in enumerate(reqs):
        t0 = time.perf_counter()
        video, latents = pipe.animate_image(
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
            generator=gen, **req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if tuple(video.shape) != (1, FRAMES, RES, RES, 3):
            raise AssertionError(f"request {i}: video shape {tuple(video.shape)}")
        if not torch.isfinite(video).all() or not torch.isfinite(latents).all():
            raise AssertionError(f"request {i}: non-finite output")
        log(f"  request {i}: {dt:.3f} s  video {tuple(video.shape)} {video.dtype} "
            f"range [{float(video.min()):.3f}, {float(video.max()):.3f}]")
    launches = {name: mod.launches for name, mod in mods.items()}
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"kernel launches during the requests: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from animate_anything_tpu_torch.ops import cuda_lib

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    ident = gpu_identity()
    log(f"gpu: {ident}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")
    log(path.with_suffix(".log").read_text().strip())

    log("kernel checks (kernel vs plain version, bf16 inputs):")
    rows = check_kernels()
    log("temporal transformers, fused vs composite path (bf16, b=2, f=17):")
    time_temporal_paths()
    check_small_unet()

    launches = run_requests()
    for row in rows:
        row["launches"] = launches[row["name"]]
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    print(json.dumps({"kernels": rows}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
