#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the torch/CUDA versions and the card's name and power limit;
2. builds the hand-written Hopper kernels from ``animate_anything_tpu_torch/csrc``;
3. checks each kernel against its plain PyTorch version at the main paths'
   shapes (bf16 inputs; the plain version computes in fp32 on the same
   inputs) and times both with CUDA events, beside the card's bound for the
   same work and, where one PyTorch call computes the same function, that
   call's time (never used by the port); the flash-attention forward and
   backward at every head size they take (ragged sq != sk; the forward's
   achieved TFLOP/s beside SDPA's; the backward called twice and held bit
   for bit) and the backward at the three training shapes; kernel 2 at its
   five shapes beside the bf16 composite's time (LayerNorm, Linear, GELU·val,
   Linear + x) and at JAX's test shapes; kernel 3 at its four sites beside
   its bf16 composite (GroupNorm apply + SiLU, one GEMM over the taps, + bias
   + x, the two sums) and at JAX's test shape and the edges of its reach,
   kernel 5 at its five sites beside its bf16 composite (LayerNorm, q/k/v
   Linear, SDPA over the frames, Linear + x) and at JAX's test shapes and the
   reach of JAX's gate (48 and 128 frames, head dims 8 to 256, c = 2048, a
   ragged s), each of the two called twice: kernel 5 and kernel 3's y bit
   for bit, kernel 3's atomic sums within a stated tolerance; the gates that
   send the head sizes the forward does not take to SDPA or the einsum form;
   the channel sums and the streaming GroupNorm (+SiLU) at the opt-in
   configuration's shapes; the fused GroupNorm-affine + SiLU -> 3x3 conv
   (kernel 8) at every resnet stage of the opt-in forward beside its bf16
   composite (affine + SiLU, cuDNN's conv2d, + bias (+ residual)), summed
   over a CFG forward by the stages' counts, at JAX's test shapes and at W >
   64, called twice (bit for bit, the channels_last weight read in place);
   the projection + residual + sums (kernel 4) at its five sites beside its
   bf16 composite and its profiled device time, summed likewise, and at
   ragged s, called twice; times one temporal
   transformer per width on its fused path (kernel 5 + kernel 2) against
   the composite path;
4. runs a small UNet on the card through the kernels (every temporal site on
   the fused path) and holds it against the same weights through the plain
   versions on the CPU: its forward, then one training loss and its
   backward with gradient checkpointing (every parameter's gradient);
5. builds the full-width mask+motion UNet, the SD VAE and the CLIP text
   encoder in bf16 from a seeded generator and answers two 512x512 /
   16-frame image-to-video requests, each an image and a prompt string
   (hash tokenizer), through ``LatentToVideoPipeline.animate_image`` (CFG 9,
   DPM-Solver++); none of kernels 6-11 may run there; then one more
   16-frame VAE decode alone for its peak memory, and the SDPA backends of
   the VAE's and the CLIP text encoder's attention;
6. answers one more such request in the JAX package's opt-in GroupNorm and
   resnet-conv configuration (``ops/spatial_conv.opt_in_config``: the
   streaming GroupNorm, the channel-sums statistics and ``AA_SPATIAL_CONV=1``),
   which must launch kernels 6-8, then decodes its latents in both
   configurations and holds the two videos together;
7. answers one more such request with the same weights in the JAX
   package's ``attn_impl="packed"`` configuration (``UNet3DConfig(...,
   attn_impl="packed")``: the composite modules, SDPA for attention, kernel
   9 for the frame attention), which must launch kernel 9 850 times (34 per
   forward) and no other kernel, then holds one CFG forward of that UNet
   against the same forward under ``attn_impl="xla"``;
8. frees that pipeline and trains the same full-width UNet on one
   512x512 / 16-frame clip (the ``configs/train_mask_motion.yaml`` values):
   the VAE encode and CLIP text inside the step, per-sub-layer gradient
   checkpointing, AdamW on fp32 masters; 1 warm-up step and 3 timed steps,
   which launch none of kernels 6-11;
9. checks that every kernel was launched on each path that runs it, prints
   one JSON line with the kernels' numbers (``launches``: the count on the
   path of the slice that brought the kernel in, the requests for kernels
   1-5, the training steps for the flash backward, the opt-in request for
   kernels 6-8, the packed request for kernel 9, and for the three functions
   that no model path reaches (the all-heads flash attention through kernel
   1, the add with its sums, kernel 10, and LayerNorm -> q/k/v -> attention,
   kernels 11 and 1) the run of those entry points at full width;
   ``launches_requests``, ``launches_opt_in``, ``launches_packed``,
   ``launches_entry_points`` and ``launches_train`` each path's), and last
   the device line.

Steps 3 and 4 also check kernel 9 against its plain version at the packed
configuration's frame-attention shapes and at JAX's ragged test shapes, the
three entry points' kernels at full-width and JAX's test shapes, and a small
UNet's forward under ``attn_impl="packed"`` on the card against the CPU.

Exits non-zero without a CUDA device, or when any phase fails.
"""

from __future__ import annotations

import copy
import gc
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# Tolerances of kernel vs plain version, both on the same bf16 inputs.
# Outputs: bf16 rounding of the stored result (2^-8 relative) plus fp32
# accumulation-order noise.
Y_ATOL, Y_RTOL = 2e-2, 1e-2
# Attention outputs at long sequences (rows 16 and 18): over N(0, 1) q/k/v
# with s keys the output averages ~s/e values of v, so its RMS is about
# sqrt(e/s), 0.026 at s = 4096, and Y_ATOL would be as large as a typical
# value. Those rows are held to the output's own scale instead: each element
# within ATTN_ATOL_RMS of the reference's RMS plus Y_RTOL of itself (one
# bf16 ulp of the stored output is 2^-8 to 2^-7 of it), and the relative RMS
# error under ATTN_REL_RMS. On the H100 the worst readings were 0.0162 of
# the RMS beyond Y_RTOL and a relative RMS error of 0.0031 (bf16 storage of
# both outputs, and for row 18 q rounded after its scale); a 1 % error in
# the softmax temperature moves the output by about 1e-2 of its RMS, a wrong
# sample or head by about 1.
ATTN_ATOL_RMS, ATTN_REL_RMS = 0.05, 1e-2
# Σy / Σy² epilogues: fp32 atomics sum in another order, and a different
# accumulation order can flip a bf16 rounding of y by one ulp (≤ 2^-7·|y|)
# at a few of the s rows of a column.
SUM_ATOL, SUM_RTOL = 0.5, 1e-3
# The sums must be those of the STORED bf16 y, which the consumer GroupNorm
# normalises: each is held against the sum of the kernel's own output, where
# only the fp32 summation order differs (~1e-4 at s = 4096). Sums of the
# unrounded fp32 y would be off by ~0.1 in Σy there.
STORED_SUM_ATOL, STORED_SUM_RTOL = 1e-2, 2e-5
# Flash backward: dq, dk, dv are sums over s of products of bf16-rounded P
# and dS; the kernel's fp32 exp2 may round a P or dS element to the other
# bf16 neighbour (2^-8 relative) than the plain version's exp does, and the
# stored gradients are bf16. Limit: 2 % of the gradient's largest magnitude
# plus 2 % of each element.
GRAD_ATOL_FRAC, GRAD_RTOL = 2e-2, 2e-2
# The two VAE decodes of the same latents, default against opt-in
# configuration: the composite GroupNorm rounds (a, b) to bf16 and applies
# them in bf16, the streaming kernel applies them in fp32 with one rounding;
# that 2^-8-relative difference at each of the decoder's 30 GroupNorms is
# carried through its convolutions. Held as a relative RMS over the video,
# like the bf16 storage noise of the small UNet.
DECODE_REL_RMS = 5e-2

# The card's peaks for the bound of each kernel's work (NVIDIA H100 SXM data
# sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

STEPS = 25
REQUESTS = 2
FRAMES = 16
RES = 512
GUIDANCE = 9.0
PROMPTS = ("a red ball rolls across a wooden table", "clouds drift over a mountain lake")
# The packed request's frame-attention sites at full width: (locations h·w,
# heads) at f = 17, d = 64, b = 2 (CFG). (4096, 8) is transformer_in.
PACKED_SITES = ((4096, 8), (4096, 5), (1024, 10), (256, 20), (64, 20))
# Kernel 9 per UNet forward: 17 temporal transformers x 2 frame attentions.
PACKED_PER_FORWARD = 34
# One CFG forward under "packed" against "xla": the same weights and inputs,
# differing only in the frame-attention core (kernel 9 against the einsum
# form, both bf16 out); bf16 rounding carried through ~100 layers.
PACKED_VS_XLA_REL_RMS = 5e-2
# The full-width temporal sites: (locations h·w, width c) at f = 17, b = 2
# (CFG); heads = c / 64. (4096, 512) is transformer_in (8 heads x 64 on 320
# channels).
TEMPORAL_SITES = ((4096, 512), (4096, 320), (1024, 640), (256, 1280), (64, 1280))
# The flash-attention sites of one UNet forward: (s, heads) at d = 64.
FLASH_SITES = ((4096, 5), (1024, 10), (256, 20))
TRAIN_STEPS = 3          # timed, after one warm-up step
TRAIN_PROMPT = "a girl moves hands"


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


def _assert_attention(name: str, got, want) -> float:
    """An attention output against its plain version at the output's own
    scale (``ATTN_ATOL_RMS``, ``ATTN_REL_RMS``); returns the max |err|."""
    got, want = got.float(), want.float()
    diff = got - want
    rms = float(want.square().mean().sqrt())
    rel = float(diff.square().mean().sqrt()) / rms
    beyond = float((diff.abs() - Y_RTOL * want.abs()).clamp(min=0).max()) / rms
    log(f"    {name}: output RMS {rms:.4g}, relative RMS error {rel:.3g} (limit "
        f"{ATTN_REL_RMS}), largest error beyond rtol {beyond:.3g} of the RMS (limit "
        f"{ATTN_ATOL_RMS})")
    _assert_close(name, got, want, ATTN_ATOL_RMS * rms, Y_RTOL)
    if rel > ATTN_REL_RMS:
        raise AssertionError(f"{name}: relative RMS error {rel:.4g} over {ATTN_REL_RMS}")
    return _err(got, want)


def _first_and_last(b: int) -> list[slice]:
    """The first two and the last two samples: the plain version's fp32
    scores for all of a full-width batch would not fit."""
    return [slice(0, 2)] + ([slice(b - 2, b)] if b > 2 else [])


def _lecun(gen, *shape, fan_in: int, dev="cuda"):
    w = torch.randn(*shape, generator=gen, device=dev) / fan_in ** 0.5
    return w.to(torch.bfloat16)


class Tally:
    """One kernel's row of the JSON line, summed over the shapes checked:
    kernel ms, plain-version ms, the bound (the larger of FLOP over the bf16
    peak and the bytes each input read once and each output written once
    over HBM's rate), the library call's ms where one exists."""

    def __init__(self, name: str, source: str, replaces: str):
        self.row = dict(name=name, route="cuda", source=source, replaces=replaces,
                        max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        bound_by="operations", library_ms=None)
        self._by = {"operations": 0.0, "bytes": 0.0}

    def add(self, tag: str, err: float, ms: float, plain: float, flop: float, nbytes: float,
            library: float | None = None) -> None:
        ops_ms, bytes_ms = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        r = self.row
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain
        r["bound_ms"] += bound
        self._by[by] += bound
        r["bound_by"] = max(self._by, key=self._by.get)
        if library is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library
        lib = "" if library is None else f"  library {library:.3f} ms"
        log(f"  {tag}: max|err| {err:.3g}  kernel {ms:.3f} ms  plain {plain:.3f} ms  "
            f"bound {bound:.3f} ms ({by}, {bound / ms:.0%} of it){lib}")


def _sdpa(q, k, v):
    """PyTorch's fused attention on (b, s, h, d) tensors: the library yardstick
    for kernel 1, timed only."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2))


# Kernel 1 and its backward at every head size they take besides the UNet's
# 64, each ragged: sq and sk not multiples of any tile, sq ≠ sk.
FLASH_HEAD_DIMS = (16, 32, 48, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256)


def check_flash(gen) -> dict:
    """The forward at the UNet's three d = 64 sites (``_flash_forward_lanes``),
    at the ragged d = 128 case of the backward check and at every other head
    size the kernel takes (``_flash_forward``'s head sizes), each beside its
    achieved TFLOP/s."""
    from animate_anything_tpu_torch.ops import flash_attention as fa

    tally = Tally("flash_attention", "animate_anything_tpu_torch/csrc/flash_attention.cu",
                  "animate_anything_tpu/ops/flash_attention.py:233")
    cases = ([(2 * (FRAMES + 1), s, s, h, 64) for s, h in FLASH_SITES] + [(2, 1000, 1000, 3, 128)]
             + [(2, 300 + 7 * d, 200 + 5 * d, 3, d) for d in FLASH_HEAD_DIMS])
    for b, sq, sk, h, d in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, sk, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        sl = slice(0, 2)  # plain fp32 scores for all 34 x h heads would not fit
        tag = f"flash_attention b={b} sq={sq} sk={sk} h={h} d={d}"
        got = fa.flash_attention(q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous())
        want = fa.attention_reference(q[sl], k[sl], v[sl])
        _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
        _assert_attention(tag, got, want)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        plain = cuda_ms(lambda: [fa.attention_reference(q[i:i + 2], k[i:i + 2], v[i:i + 2])
                                 for i in range(0, b, 2)], warmup=1, iters=2)
        library = cuda_ms(lambda: _sdpa(q, k, v))
        flop = 4 * b * h * sq * sk * d
        tally.add(tag, _err(got, want), ms, plain, flop, 2 * b * (sq + sk) * h * d * 2, library)
        log(f"    {flop / ms / 1e9:.1f} TFLOP/s (SDPA {flop / library / 1e9:.1f})")
    return tally.row


def check_attention_gates(gen) -> None:
    """Head sizes the kernels do not take run without raising through their
    gates: ``attention(impl="pallas")`` sends d % 16 == 8 and d > 256 to SDPA
    (no kernel-1 launch) and takes kernel 1 at d = 96; ``temporal_attention``
    under ``"packed"`` keeps the einsum form above d = 128 (no kernel-9
    launch). Each output against its plain version."""
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops import temporal_attention as ta
    from animate_anything_tpu_torch.ops.attention import attention

    for d, kernel in ((40, False), (320, False), (96, True)):
        q, k, v = (torch.randn(2, 300, 2, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        before = fa.launches
        with torch.no_grad():
            got = attention(q, k, v, impl="pallas")
        ran = fa.launches - before
        want = fa.attention_reference(q, k, v)
        _assert_close(f"attention d={d}", got, want, Y_ATOL, Y_RTOL)
        if ran != int(kernel):
            raise AssertionError(f"attention d={d}: kernel 1 launched {ran} times")
        log(f"  attention(impl='pallas') d={d}: {'kernel 1' if kernel else 'SDPA'}, "
            f"max|err| {_err(got, want):.3g}")
    q, k, v = (torch.randn(1, 17, 64, 8, 160, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = ta.launches
    with torch.no_grad():
        got = ta.temporal_attention(q, k, v, impl="packed")
    if ta.launches != before:
        raise AssertionError("temporal_attention d=160: kernel 9 launched")
    _assert_close("temporal_attention d=160", got, ta.temporal_attention_reference(q, k, v),
                  Y_ATOL, Y_RTOL)
    log("  temporal_attention(impl='packed') d=160: einsum form, no kernel 9")
    check_wide_head_temporal(gen)


# A temporal transformer whose head dim kernel 5 does not take (d = 320 > 256)
# but JAX's gate ``fused_ok`` sends to its fused block: bf16 on the card
# against the same weights in fp32 on the CPU, as a relative RMS of bf16
# storage through LayerNorm, two frame attentions and the GEGLU tail.
WIDE_HEAD_REL_RMS = 2e-2


def check_wide_head_temporal(gen) -> None:
    """c = 640 with 2 heads at 17 frames on the card: the fused branch runs
    each LN + frame attention as the composite does (no kernel-5 launch)
    and keeps kernel 2's tail and kernel 4's projection, where kernel 5
    would raise; held against the CPU."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models.attention import TemporalTransformer
    from animate_anything_tpu_torch.ops import geglu, temporal_block
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    f, c, heads = FRAMES + 1, 640, 2
    if temporal_block.kernel_ok(f, c, heads) or not temporal_block.fused_ok(f, c, heads,
                                                                            c // heads):
        raise AssertionError("d = 320: expected JAX's gate to admit it and kernel 5 not")
    tt = init_unet3d_(TemporalTransformer(c, heads, c // heads), torch.Generator().manual_seed(7))
    x = torch.randn(2 * f, 4, 4, c, generator=gen, device="cuda")
    with torch.no_grad():
        want, _ = tt.eval()(x.cpu(), f)
        card = cast_module_(copy.deepcopy(tt).cuda()).eval()
        k5, k2 = temporal_block.launches, geglu.launches
        got, sums = card(x.to(torch.bfloat16), f)
        torch.cuda.synchronize()
    if temporal_block.launches != k5 or geglu.launches != k2 + 1:
        raise AssertionError(f"d = 320: kernel 5 launched {temporal_block.launches - k5} times, "
                             f"kernel 2 {geglu.launches - k2}")
    rel = float((got.float().cpu() - want).square().mean().sqrt() / want.square().mean().sqrt())
    if not torch.isfinite(got).all() or rel > WIDE_HEAD_REL_RMS:
        raise AssertionError(f"d = 320 temporal transformer: relative RMS {rel:.4g}")
    log(f"  temporal transformer c={c} heads={heads} (d=320): composite attention, kernel 2 "
        f"tail, no kernel 5; relative RMS against the CPU {rel:.3g} (limit {WIDE_HEAD_REL_RMS})")


def _sdpa_backward(q, k, v, do):
    """SDPA's flash backward alone, on the saved outputs of its forward: the
    library yardstick for the flash backward, timed only. Called as the aten
    op, so its time is the backward's device work, without the autograd
    engine's host time around ``torch.autograd.grad``."""
    qs, ks, vs, dos = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = (
        torch.ops.aten._scaled_dot_product_flash_attention(qs, ks, vs))
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dos, qs, ks, vs, out, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset)


def _flash_bwd_case(gen, b, sq, sk, h, d, tally) -> None:
    from animate_anything_tpu_torch.ops import flash_attention as fa

    q, do = (torch.randn(b, sq, h, d, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = fa.flash_forward_with_lse(q, k, v)
    got = fa.flash_attention_backward(q, k, v, o, do, lse)
    # No atomics: a second call gives the same bits.
    again = fa.flash_attention_backward(q, k, v, o, do, lse)
    tag = f"b={b} sq={sq} sk={sk} h={h} d={d}"
    for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(g, g2):
            raise AssertionError(f"flash backward {name} {tag}: two calls differ")
    sl = slice(0, 2)
    want = fa.flash_attention_backward_reference(q[sl], k[sl], v[sl], o[sl], do[sl])
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(f"flash backward {name} {tag}", g[sl], w,
                      GRAD_ATOL_FRAC * float(w.float().abs().max()), GRAD_RTOL)
        err = max(err, _err(g[sl], w))
    ms = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, o, do, lse))
    plain = cuda_ms(lambda: [fa.flash_attention_backward_reference(
        q[i:i + 2], k[i:i + 2], v[i:i + 2], o[i:i + 2], do[i:i + 2]) for i in range(0, b, 2)],
        warmup=1, iters=2)
    library = cuda_ms(_sdpa_backward(q, k, v, do), warmup=5, iters=20)
    # q k v o dO in, dq dk dv out; lse
    nbytes = (4 * sq + 4 * sk) * b * h * d * 2 + b * h * sq * 4
    tally.add(f"flash backward {tag}", err, ms, plain, 10 * b * h * sq * sk * d, nbytes, library)


def check_flash_backward(gen) -> dict:
    """The dq and dk/dv kernels at the three training sites (one sample: 16
    frames + the condition frame), one ragged case with odd heads at
    d = 128 and every head size they take besides 64, ragged with sq != sk
    (``_flash_backward``'s head sizes), each called twice and held bit for
    bit; SDPA's backward as the library time."""
    tally = Tally("flash_attention_bwd", "animate_anything_tpu_torch/csrc/flash_attention_bwd.cu",
                  "animate_anything_tpu/ops/flash_attention.py:618")
    for s, h in FLASH_SITES:
        _flash_bwd_case(gen, FRAMES + 1, s, s, h, 64, tally)
        torch.cuda.empty_cache()
    _flash_bwd_case(gen, 2, 1000, 1000, 3, 128, tally)
    for d in FLASH_HEAD_DIMS:
        _flash_bwd_case(gen, 2, 300 + 7 * d, 200 + 5 * d, 3, d, tally)
    return tally.row


# Kernel 2 at the UNet's five temporal-transformer shapes (34 frames x
# locations, c), then at the JAX package's test shapes (ragged n, small c).
GEGLU_SHAPES = ((34 * 4096, 320), (34 * 4096, 512), (34 * 1024, 640), (34 * 256, 1280),
                (34 * 64, 1280))
GEGLU_TEST_SHAPES = ((40, 128), (24, 64), (272, 256), (300, 48))


def _geglu_args(gen, n, c):
    x = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
    s = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    w1 = _lecun(gen, 8 * c, c, fan_in=c)
    b1 = 0.1 * torch.randn(8 * c, generator=gen, device="cuda")
    w2 = _lecun(gen, c, 4 * c, fan_in=4 * c)
    b2 = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, s, b, w1, b1, w2, b2


def _geglu_composite(x, s, b, w1, b1, w2, b2):
    """The same function as PyTorch calls in bf16 (``F.layer_norm``, two
    ``F.linear``, tanh GELU): the yardstick a redesign of kernel 2 has to
    beat, timed only and never called by the port."""
    c = x.shape[-1]
    bf = torch.bfloat16
    h = F.linear(F.layer_norm(x, (c,), s.to(bf), b.to(bf)), w1, b1.to(bf))
    val, gate = h.chunk(2, dim=-1)
    return x + F.linear(val * F.gelu(gate, approximate="tanh"), w2, b2.to(bf))


def check_geglu(gen) -> dict:
    """Kernel 2 (LN pass, GEGLU GEMM, residual GEMM) against its plain
    version at the main path's five shapes, each beside the bf16 composite's
    time (a reference line, ``composite_ms``), then at JAX's test shapes."""
    from animate_anything_tpu_torch.ops import geglu

    tally = Tally("ln_geglu_ff", "animate_anything_tpu_torch/csrc/geglu.cu",
                  "animate_anything_tpu/ops/geglu.py:116")
    composite_ms = 0.0
    for n, c in GEGLU_SHAPES:
        args = _geglu_args(gen, n, c)
        got = geglu.ln_geglu_ff(*args)
        want = geglu.ln_geglu_reference(*args, 1e-5)
        _assert_close(f"ln_geglu n={n} c={c}", got, want, Y_ATOL, Y_RTOL)
        ms = cuda_ms(lambda: geglu.ln_geglu_ff(*args))
        plain = cuda_ms(lambda: geglu.ln_geglu_reference(*args, 1e-5), warmup=1, iters=3)
        with torch.no_grad():
            comp = cuda_ms(lambda: _geglu_composite(*args))
        composite_ms += comp
        log(f"    bf16 composite (LN, Linear, GELU·val, Linear + x; a reference line) "
            f"{comp:.3f} ms")
        nbytes = 2 * n * c * 2 + 12 * c * c * 2 + (8 * c + 3 * c) * 4
        tally.add(f"ln_geglu_ff n={n} c={c}", _err(got, want), ms, plain,
                  24 * n * c * c, nbytes)
        del args, got, want
        torch.cuda.empty_cache()
    for n, c in GEGLU_TEST_SHAPES:
        args = _geglu_args(gen, n, c)
        got = geglu.ln_geglu_ff(*args)
        want = geglu.ln_geglu_reference(*args, 1e-5)
        _assert_close(f"ln_geglu n={n} c={c}", got, want, Y_ATOL, Y_RTOL)
        log(f"  ln_geglu_ff n={n} c={c}: max|err| {_err(got, want):.3g}")
    tally.row["composite_ms"] = composite_ms
    return tally.row


# Kernel 3 at the UNet's four temporal-conv sites (b = 2 for CFG, 17 frames,
# locations s, c -> c), then at the JAX package's test shape (tests/test_ops.py:
# 2 x 5 frames x 24 locations, 128 -> 128) and at edges of the kernel's
# reach: ragged s (sub-tiles of 64 rows cut by the slab), cin % 64 == 32,
# cin = 32, one frame (both outer taps past the ends), cout < 64.
TAP_CONV_SITES = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
TAP_CONV_TEST_SHAPES = ((2, 5, 24, 128, 128), (1, 3, 100, 96, 40), (2, 5, 200, 32, 128),
                        (1, 1, 70, 64, 64), (2, 4, 16, 64, 64))
# Two calls of kernel 3: y is bit for bit the same (no atomics reach it);
# each Σy, Σy² is a sum of at most s/64 fp32 atomic adds of 64-row partials
# (at most 64 at s = 4096) in an order that changes from call to call, and
# reassociating n fp32 adds moves a sum by at most (n − 1)·2^-24 of the sum
# of the magnitudes added (3.8e-6 at n = 64): held to 1e-5 of Σ|y| (Σy²).
ATOMIC_SUM_RTOL = 1e-5


def _tap_conv_composite(x, a, b, w, bias, res):
    """The same function as PyTorch calls in bf16: the GroupNorm apply and
    SiLU as one pass over x, one cuBLAS GEMM over the concatenated taps, +
    bias + residual, the two sums. The yardstick a redesign of kernel 3 has
    to beat, timed only and never called by the port."""
    bf = torch.bfloat16
    act = F.silu(torch.addcmul(b.to(bf)[:, None, None], x, a.to(bf)[:, None, None]))
    taps = torch.cat([F.pad(act[:, :-1], (0, 0, 0, 0, 1, 0)), act,
                      F.pad(act[:, 1:], (0, 0, 0, 0, 0, 1))], -1)
    y = F.linear(taps, w.reshape(w.shape[0], -1), bias.to(bf)) + res
    yf = y.float()
    return y, (yf.sum(2), yf.square().sum(2))


def _tap_conv_args(gen, bsz, f, s, cin, cout):
    x = torch.randn(bsz, f, s, cin, generator=gen, device="cuda").to(torch.bfloat16)
    a = 1.0 + 0.1 * torch.randn(bsz, cin, generator=gen, device="cuda")
    b = 0.1 * torch.randn(bsz, cin, generator=gen, device="cuda")
    w = _lecun(gen, cout, 3, cin, fan_in=3 * cin)
    bias = 0.1 * torch.randn(cout, generator=gen, device="cuda")
    res = torch.randn(bsz, f, s, cout, generator=gen, device="cuda").to(torch.bfloat16)
    return x, a, b, w, bias, res


def _tap_conv_case(tag: str, x, a, b, w, bias, residual) -> float:
    """Kernel 3 against its plain version, and a second call against the
    first (y bit for bit, the sums within ``ATOMIC_SUM_RTOL``)."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    y, (s1, s2) = tc.tap_conv(x, a, b, w, bias, residual)
    y2, (t1, t2) = tc.tap_conv(x, a, b, w, bias, residual)
    wy, (w1, w2) = tc.tap_conv_reference(x, a, b, w, bias, residual)
    _assert_close(tag, y, wy, Y_ATOL, Y_RTOL)
    _assert_close(tag + " Σy", s1, w1, SUM_ATOL, SUM_RTOL)
    _assert_close(tag + " Σy²", s2, w2, SUM_ATOL, SUM_RTOL)
    _assert_stored_sums(tag, y, (s1, s2), dim=2)
    if not torch.equal(y, y2):
        raise AssertionError(f"{tag}: two calls give different y")
    yf = y.float()
    for name, got, first, mag in (("Σy", t1, s1, yf.abs().sum(2)),
                                  ("Σy²", t2, s2, yf.square().sum(2))):
        if bool(((got - first).abs() > ATOMIC_SUM_RTOL * mag).any()):
            raise AssertionError(f"{tag} {name}: two calls differ by more than "
                                 f"{ATOMIC_SUM_RTOL} of the magnitudes summed")
    return _err(y, wy)


def check_tap_conv(gen) -> dict:
    """Kernel 3 at the main path's four sites, each with and without the
    residual, called twice; timed beside the bf16 composite
    (``composite_ms``), then at JAX's test shape and the edges of its reach."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    tally = Tally("tap_conv", "animate_anything_tpu_torch/csrc/temporal_conv.cu",
                  "animate_anything_tpu/ops/temporal_conv.py:159")
    bsz, f = 2, FRAMES + 1
    composite_ms = 0.0
    for s, c in TAP_CONV_SITES:
        x, a, b, w, bias, res = _tap_conv_args(gen, bsz, f, s, c, c)
        err = max(_tap_conv_case(f"tap_conv s={s} c={c} residual={r is not None}", x, a, b, w,
                                 bias, r) for r in (None, res))
        ms = cuda_ms(lambda: tc.tap_conv(x, a, b, w, bias, res))
        plain = cuda_ms(lambda: tc.tap_conv_reference(x, a, b, w, bias, res), warmup=1, iters=3)
        with torch.no_grad():
            comp = cuda_ms(lambda: _tap_conv_composite(x, a, b, w, bias, res))
        composite_ms += comp
        log(f"    bf16 composite (GN apply + SiLU, one GEMM over the taps, + bias + x, "
            f"two sums; a reference line) {comp:.3f} ms")
        rows = bsz * f * s
        nbytes = 3 * rows * c * 2 + 3 * c * c * 2 + 2 * bsz * f * c * 4
        # FLOP of the taps that land on a frame: the outer taps of the first
        # and the last frame fall on JAX's zero frames, which the kernel skips
        tally.add(f"tap_conv bsz={bsz} f={f} s={s} c={c}", err, ms, plain,
                  2 * bsz * s * (3 * f - 2) * c * c, nbytes)
        del x, res
        torch.cuda.empty_cache()
    for bsz_, f_, s_, cin, cout in TAP_CONV_TEST_SHAPES:
        x, a, b, w, bias, res = _tap_conv_args(gen, bsz_, f_, s_, cin, cout)
        tag = f"tap_conv bsz={bsz_} f={f_} s={s_} cin={cin} cout={cout}"
        err = max(_tap_conv_case(f"{tag} residual={r is not None}", x, a, b, w, bias, r)
                  for r in (None, res))
        log(f"  {tag}: max|err| {err:.3g}")
    tally.row["composite_ms"] = composite_ms
    return tally.row


# Beyond kernel 4's sites (``utils/kernel_sites.PROJ_SITES``): ragged s, the
# last 64-row sub-tile of each slab cut by the slab, as (n, s, k, c).
PROJ_TEST_SHAPES = ((34, 100, 320, 320), (3, 100, 64, 128))


def _proj_composite(h, w, bias, r):
    """The same function as PyTorch calls in bf16: ``F.linear`` with the bias,
    + the residual, the two sums of the stored y. A reference line, timed
    only and never called by the port."""
    y = F.linear(h, w, bias.to(h.dtype)) + r
    yf = y.float()
    return y, (yf.sum(1), yf.square().sum(1))


def _proj_case(gen, n, s, k, c):
    """Kernel 4 against its plain version, and a second call against the
    first: y bit for bit, the atomic sums within ``ATOMIC_SUM_RTOL``."""
    from animate_anything_tpu_torch.ops import proj_residual as pr

    h = torch.randn(n, s, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = _lecun(gen, c, k, fan_in=k)
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    r = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
    y, (s1, s2) = pr.proj_residual_stats(h, w, bias, r)
    y2, (t1, t2) = pr.proj_residual_stats(h, w, bias, r)
    wy, (w1, w2) = pr.proj_residual_reference(h, w, bias, r)
    tag = f"proj_residual n={n} s={s} k={k} c={c}"
    _assert_close(tag, y, wy, Y_ATOL, Y_RTOL)
    _assert_close(tag + " Σy", s1, w1, SUM_ATOL, SUM_RTOL)
    _assert_close(tag + " Σy²", s2, w2, SUM_ATOL, SUM_RTOL)
    _assert_stored_sums(tag, y, (s1, s2), dim=1)
    if not torch.equal(y, y2):
        raise AssertionError(f"{tag}: two calls give different y")
    yf = y.float()
    for name, got, first, mag in (("Σy", t1, s1, yf.abs().sum(1)),
                                  ("Σy²", t2, s2, yf.square().sum(1))):
        if bool(((got - first).abs() > ATOMIC_SUM_RTOL * mag).any()):
            raise AssertionError(f"{tag} {name}: two calls differ by more than "
                                 f"{ATOMIC_SUM_RTOL} of the magnitudes summed")
    return tag, (h, w, bias, r), _err(y, wy)


def _device_ms(fn, group: str, iters: int = 20) -> float | None:
    """Device time of ``group``'s kernels a call of fn, from one profiled run
    of ``iters`` calls (``utils/profiling.device_profile``): the kernel's
    own time, where CUDA events around a loop of short calls also time the
    host that issues them. None where the profiler saw no device time."""
    from animate_anything_tpu_torch.utils.profiling import device_profile

    ms = device_profile(lambda: [fn() for _ in range(iters)])["groups"].get(group)
    return None if not ms else ms / iters


def _proj_width_device_ms(args, want) -> dict:
    """Kernel 4's device time at one site with each tile width of its
    instantiations forced on the plan (the plan's choice narrowed to one
    width), each held against the plain version ``want``: what the plan's
    pick is measured against."""
    from animate_anything_tpu_torch.ops import proj_residual as pr

    widths, out = pr.TILE_WIDTHS, {}
    try:
        for bn in widths:
            pr.TILE_WIDTHS = (bn,)
            with torch.no_grad():
                _assert_close(f"proj_residual bn={bn}", pr.proj_residual_stats(*args)[0], want,
                              Y_ATOL, Y_RTOL)
                out[bn] = _device_ms(lambda: pr.proj_residual_stats(*args),
                                     "proj_residual (kernel 4)")
    finally:
        pr.TILE_WIDTHS = widths
    return out


def check_proj_residual(gen) -> dict:
    """Kernel 4 at its five sites, each called twice, timed by CUDA events
    and by the profiler's device time (``site_device_ms``) beside its bf16
    composite (``composite_ms``) and summed over a CFG forward by the sites'
    counts (``forward_ms``, ``forward_device_ms``, ``forward_bound_ms``,
    ``forward_composite_ms``); at s = 64 also by tile width
    (``s64_width_device_ms``: 85 tiles of 256 columns leave 47 SMs idle);
    then at ragged s."""
    from animate_anything_tpu_torch.ops import proj_residual as pr
    from animate_anything_tpu_torch.utils.kernel_sites import PROJ_SITES

    tally = Tally("proj_residual_stats", "animate_anything_tpu_torch/csrc/proj_residual.cu",
                  "animate_anything_tpu/ops/proj_residual.py:83")
    n = 2 * (FRAMES + 1)
    composite_ms = forward = forward_bound = forward_comp = 0.0
    device = []
    for s, k, c, count in PROJ_SITES:
        tag, args, err = _proj_case(gen, n, s, k, c)
        ms = cuda_ms(lambda: pr.proj_residual_stats(*args))
        with torch.no_grad():
            device.append(_device_ms(lambda: pr.proj_residual_stats(*args),
                                     "proj_residual (kernel 4)"))
        plain = cuda_ms(lambda: pr.proj_residual_reference(*args), warmup=1, iters=3)
        with torch.no_grad():
            comp = cuda_ms(lambda: _proj_composite(*args))
        composite_ms += comp
        flop = 2 * n * s * k * c
        nbytes = n * s * (k + 2 * c) * 2 + k * c * 2 + 2 * n * c * 4
        forward += count * ms
        forward_bound += count * max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        forward_comp += count * comp
        dev = "not measured" if device[-1] is None else f"{device[-1]:.3f} ms"
        log(f"    device time (profiler) {dev}; bf16 composite (Linear + bias, + residual, two "
            f"sums; a reference line) {comp:.3f} ms; {count} a CFG forward")
        tally.add(tag, err, ms, plain, flop, nbytes)
        if s == 64:
            widths = _proj_width_device_ms(args, pr.proj_residual_reference(*args)[0])
            tally.row["s64_width_device_ms"] = widths
            log(f"    s=64 device ms by tile width {widths}; the plan picks "
                f"{pr.launch_plan(n, s, k, c)['bn']}")
    for shape in PROJ_TEST_SHAPES:
        tag, _, err = _proj_case(gen, *shape)
        log(f"  {tag}: max|err| {err:.3g}")
    forward_device = (None if None in device else
                      sum(d * site[-1] for d, site in zip(device, PROJ_SITES)))
    tally.row.update(composite_ms=composite_ms, forward_ms=forward, forward_bound_ms=forward_bound,
                     forward_composite_ms=forward_comp, site_device_ms=device,
                     forward_device_ms=forward_device)
    log(f"  kernel 4 a CFG forward (33 launches by the sites' counts): {forward:.3f} ms against "
        f"a bound of {forward_bound:.3f} ms ({forward_bound / forward:.0%}); device time "
        f"{forward_device}; bf16 composite {forward_comp:.3f} ms")
    return tally.row


# Kernel 5 beyond the UNet's sites: the JAX package's test shapes (tests/
# test_torch_port_temporal_block.py: ragged s = 120 at d = 64, d = 8, f = 4),
# then the reach JAX's gate ``fused_ok`` admits: f = 48 with d = 40 (d % 16 ==
# 8) at a ragged s, d = 72, 128 and 256, f = 128, c = 2048. (b, f, s, c, heads).
TEMPORAL_BLOCK_TEST_SHAPES = ((2, 17, 120, 128, 2), (2, 17, 120, 64, 8), (2, 4, 9, 64, 2),
                              (2, 48, 51, 80, 2), (1, 33, 20, 144, 2), (1, 128, 5, 256, 2),
                              (1, 20, 33, 512, 2), (1, 8, 16, 2048, 8))


def _temporal_block_args(gen, b, f, s, c):
    x = torch.randn(b, f, s, c, generator=gen, device="cuda").to(torch.bfloat16)
    ln_s = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    ln_b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    ws = [_lecun(gen, c, c, fan_in=c) for _ in range(4)]
    bo = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return (x, ln_s, ln_b, *ws, bo)


def _temporal_block_composite(x, ln_s, ln_b, wq, wk, wv, wo, bo, heads):
    """The same function as PyTorch calls in bf16: ``F.layer_norm``, three
    ``F.linear``, SDPA over the frames of each (location, head) on a
    contiguous (b·s, heads, f, d) copy, ``F.linear`` + x. A reference line,
    timed only and never called by the port."""
    b, f, s, c = x.shape
    d, bf = c // heads, torch.bfloat16
    ln = F.layer_norm(x, (c,), ln_s.to(bf), ln_b.to(bf))
    q, k, v = (F.linear(ln, w).view(b, f, s, heads, d).permute(0, 2, 3, 1, 4)
               .reshape(b * s, heads, f, d) for w in (wq, wk, wv))
    o = F.scaled_dot_product_attention(q, k, v).view(b, s, heads, f, d)
    return x + F.linear(o.permute(0, 3, 1, 2, 4).reshape(b, f, s, c), wo, bo.to(bf))


def _temporal_block_case(tag: str, args, heads: int) -> float:
    """Kernel 5 against its plain version, and a second call against the
    first, bit for bit (no atomics)."""
    from animate_anything_tpu_torch.ops import temporal_block as tb

    got = tb.temporal_block(*args, heads=heads)
    again = tb.temporal_block(*args, heads=heads)
    want = tb.temporal_block_reference(*args, heads=heads)
    _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: two calls differ")
    return _err(got, want)


def check_temporal_block(gen) -> dict:
    """Kernel 5 at the main path's five sites, called twice, timed beside
    the bf16 composite (``composite_ms``), then at JAX's test shapes and
    the edges of its reach."""
    from animate_anything_tpu_torch.ops import temporal_block as tb

    tally = Tally("temporal_block", "animate_anything_tpu_torch/csrc/temporal_block.cu",
                  "animate_anything_tpu/ops/temporal_block.py:408")
    b, f = 2, FRAMES + 1
    composite_ms = 0.0
    for s, c in TEMPORAL_SITES:
        heads = c // 64
        args = _temporal_block_args(gen, b, f, s, c)
        tag = f"temporal_block b={b} f={f} s={s} c={c} heads={heads}"
        err = _temporal_block_case(tag, args, heads)
        ms = cuda_ms(lambda: tb.temporal_block(*args, heads=heads))
        plain = cuda_ms(lambda: tb.temporal_block_reference(*args, heads=heads), warmup=1,
                        iters=3)
        with torch.no_grad():
            comp = cuda_ms(lambda: _temporal_block_composite(*args, heads))
        composite_ms += comp
        log(f"    bf16 composite (LayerNorm, q/k/v Linear, SDPA over the frames, Linear + x; "
            f"a reference line) {comp:.3f} ms")
        rows = b * f * s
        flop = 8 * rows * c * c + 4 * b * s * heads * f * f * 64
        nbytes = 2 * rows * c * 2 + 4 * c * c * 2 + 3 * c * 4
        tally.add(tag, err, ms, plain, flop, nbytes)
        del args
        torch.cuda.empty_cache()
    for b_, f_, s_, c, heads in TEMPORAL_BLOCK_TEST_SHAPES:
        tag = f"temporal_block b={b_} f={f_} s={s_} c={c} heads={heads} d={c // heads}"
        err = _temporal_block_case(tag, _temporal_block_args(gen, b_, f_, s_, c), heads)
        log(f"  {tag}: max|err| {err:.3g}")
    tally.row["composite_ms"] = composite_ms
    return tally.row


def check_channel_sums(gen) -> dict:
    """Kernel 6 at the UNet's 320-wide statistics sites of the opt-in
    configuration: a resnet stage's input (34 frames of 64x64) and a
    temporal conv's first stage (2 samples x 17 frames x 64x64)."""
    from animate_anything_tpu_torch.ops import group_norm as gn

    tally = Tally("channel_sums", "animate_anything_tpu_torch/csrc/group_norm.cu",
                  "animate_anything_tpu/ops/group_norm.py:102")
    for n, s, c in ((2 * (FRAMES + 1), 4096, 320), (2, (FRAMES + 1) * 4096, 320)):
        x = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        got = gn.stream_channel_sums(x)
        want = gn.channel_sums(x)
        tag = f"channel_sums n={n} s={s} c={c}"
        # the same fp32 sums in another order
        _assert_close(tag + " Σx", got[0], want[0], STORED_SUM_ATOL, STORED_SUM_RTOL)
        _assert_close(tag + " Σx²", got[1], want[1], STORED_SUM_ATOL, STORED_SUM_RTOL)
        ms = cuda_ms(lambda: gn.stream_channel_sums(x))
        plain = cuda_ms(lambda: gn.channel_sums(x))
        tally.add(tag, max(_err(got[0], want[0]), _err(got[1], want[1])), ms, plain,
                  3 * n * s * c, n * s * c * 2 + 2 * n * c * 4)
    return tally.row


def check_streaming_gn(gen) -> dict:
    """Kernel 7 at the VAE decoder's four levels at 16 frames (GroupNorm +
    SiLU) and at the 64x64x512 level without SiLU (the mid-block attention's
    norm); F.group_norm as the library time there."""
    from animate_anything_tpu_torch.ops import streaming_group_norm as sg

    tally = Tally("group_norm_stream", "animate_anything_tpu_torch/csrc/group_norm.cu",
                  "animate_anything_tpu/ops/attic/streaming_group_norm.py:110")
    for hw, c, silu in ((64, 512, True), (128, 512, True), (256, 256, True), (512, 128, True),
                        (64, 512, False)):
        n, s, groups = FRAMES, hw * hw, 32
        x = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        with torch.no_grad():
            got = sg.group_norm_stream(x, scale, bias, groups, 1e-6, silu)
            want = sg.group_norm_stream_reference(x, scale, bias, groups, 1e-6, silu)
            tag = f"group_norm_stream n={n} s={hw}x{hw} c={c} silu={silu}"
            _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
            ms = cuda_ms(lambda: sg.group_norm_stream(x, scale, bias, groups, 1e-6, silu))
            plain = cuda_ms(lambda: sg.group_norm_stream_reference(x, scale, bias, groups, 1e-6,
                                                                   silu), warmup=1, iters=3)
            library = None
            if not silu:   # one call of the same function (weights in x's dtype)
                sb, bb = scale.to(x.dtype), bias.to(x.dtype)
                library = cuda_ms(lambda: F.group_norm(x.transpose(1, 2), groups, sb, bb, 1e-6))
        nbytes = 2 * n * s * c * 2 + 2 * c * 4
        tally.add(tag, _err(got, want), ms, plain, (8 if silu else 3) * n * s * c, nbytes,
                  library)
        log(f"    bound with x read twice (the kernel's two passes): "
            f"{3 * n * s * c * 2 / PEAK_HBM_BYTES * 1e3:.3f} ms")
    return tally.row


# Beyond the UNet's sites, (n, H, W, cin, cout, time bias, residual): JAX's test
# shape (tests/test_torch_port_spatial_conv.py) and W > 64, where a sub-tile
# is a 64-pixel run of one row and rows end past W.
SPATIAL_CONV_TEST_SHAPES = ((2, 16, 16, 64, 48, False, True), (1, 5, 100, 32, 64, True, True))


def _spatial_conv_args(gen, n, h, w, cin, cout, extra, residual):
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(torch.bfloat16)
    a = 1.0 + 0.1 * torch.randn(n, cin, generator=gen, device="cuda")
    b = 0.1 * torch.randn(n, cin, generator=gen, device="cuda")
    # channels_last, as the port's Conv2d holds its weight: the kernel reads it in place
    wt = _lecun(gen, cout, cin, 3, 3, fan_in=9 * cin).contiguous(memory_format=torch.channels_last)
    bias = 0.1 * torch.randn(cout, generator=gen, device="cuda")[None, :].repeat(n, 1)
    if extra:
        bias = bias + 0.1 * torch.randn(n, cout, generator=gen, device="cuda")
    res = (torch.randn(n, h, w, cout, generator=gen, device="cuda").to(torch.bfloat16)
           if residual else None)
    return x, a, b, wt, bias, res


def _spatial_conv_composite(x, a, b, w, bias, res):
    """The same function as PyTorch calls in bf16: the GroupNorm-affine and
    SiLU as one pass over x, cuDNN's ``F.conv2d`` on the channels-last view,
    + bias (+ residual). The yardstick kernel 8 has to beat, timed only and
    never called by the port."""
    bf = torch.bfloat16
    act = F.silu(torch.addcmul(b.to(bf)[:, None, None], x, a.to(bf)[:, None, None]))
    y = F.conv2d(act.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    y = y + bias.to(bf)[:, None, None]
    return y if res is None else y + res


def _spatial_conv_case(tag: str, args) -> float:
    """Kernel 8 against its plain version, and a second call against the
    first, bit for bit (no atomics); the channels_last weight is the
    kernel's operand as it is, with no copy."""
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    if sc.pack_weight(args[3]).data_ptr() != args[3].data_ptr():
        raise AssertionError(f"{tag}: the weight is not the kernel's operand in place")
    with torch.no_grad():
        got = sc.spatial_conv(*args)
        again = sc.spatial_conv(*args)
        want = sc.spatial_conv_reference(*args, True)
    _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: two calls differ")
    return _err(got, want)


def check_spatial_conv(gen) -> dict:
    """Kernel 8 at every resnet stage of the opt-in forward
    (``utils/kernel_sites.SPATIAL_CONV_SITES``), each called
    twice, timed beside its bf16 composite (``composite_ms``) and summed
    over a CFG forward by the sites' launch counts (``forward_ms``,
    ``forward_bound_ms``, ``forward_composite_ms``); then at JAX's test
    shape, at W > 64 and at JAX's conv3x3 test shape (``gn_silu_conv3x3``'s
    stage: no residual, always SiLU)."""
    from animate_anything_tpu_torch.ops import spatial_conv as sc
    from animate_anything_tpu_torch.utils.kernel_sites import SPATIAL_CONV_SITES

    tally = Tally("spatial_conv", "animate_anything_tpu_torch/csrc/spatial_conv.cu",
                  "animate_anything_tpu/ops/attic/spatial_conv.py:197")
    tally.row["replaces_also"] = "animate_anything_tpu/ops/attic/conv3x3.py:128"
    n = 2 * (FRAMES + 1)
    composite_ms = forward = forward_bound = forward_comp = 0.0
    for hw, cin, cout, extra, residual, count in SPATIAL_CONV_SITES:
        args = _spatial_conv_args(gen, n, hw, hw, cin, cout, extra, residual)
        tag = f"spatial_conv n={n} {hw}x{hw} {cin}->{cout} time_bias={extra} residual={residual}"
        err = _spatial_conv_case(tag, args)
        with torch.no_grad():
            ms = cuda_ms(lambda: sc.spatial_conv(*args))
            plain = cuda_ms(lambda: sc.spatial_conv_reference(*args, True), warmup=1, iters=3)
            comp = cuda_ms(lambda: _spatial_conv_composite(*args))
        composite_ms += comp
        pixels = n * hw * hw
        # FLOP of the (pixel, tap) pairs that land in the image: (3H - 2)(3W - 2)
        # of an image's 9HW; the others read the zero padding
        flop = 2 * n * (3 * hw - 2) ** 2 * cin * cout
        nbytes = pixels * (cin + cout * (2 if residual else 1)) * 2 + 9 * cin * cout * 2 \
            + (2 * cin + cout) * n * 4
        forward += count * ms
        forward_bound += count * max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        forward_comp += count * comp
        log(f"    bf16 composite (affine + SiLU, cuDNN conv2d, + bias (+ residual); a reference "
            f"line) {comp:.3f} ms; {count} a CFG forward")
        tally.add(tag, err, ms, plain, flop, nbytes)
        del args
        torch.cuda.empty_cache()
    for n_, h, w, cin, cout, extra, residual in SPATIAL_CONV_TEST_SHAPES:
        tag = f"spatial_conv n={n_} {h}x{w} {cin}->{cout} time_bias={extra} residual={residual}"
        args = _spatial_conv_args(gen, n_, h, w, cin, cout, extra, residual)
        log(f"  {tag}: max|err| {_spatial_conv_case(tag, args):.3g}")
    tag = "gn_silu_conv3x3's stage n=2 8x8 32->48 time_bias=True"
    args = _spatial_conv_args(gen, 2, 8, 8, 32, 48, True, False)
    log(f"  {tag}: max|err| {_spatial_conv_case(tag, args):.3g}")
    tally.row.update(composite_ms=composite_ms, forward_ms=forward, forward_bound_ms=forward_bound,
                     forward_composite_ms=forward_comp)
    log(f"  kernel 8 a CFG forward (44 stages by the sites' counts): {forward:.3f} ms against a "
        f"bound of {forward_bound:.3f} ms ({forward_bound / forward:.0%}); bf16 composite "
        f"{forward_comp:.3f} ms")
    return tally.row


def check_temporal_attention(gen) -> dict:
    """Kernel 9 at the packed request's five frame-attention sites, at JAX's
    ragged test shapes (locations that do not fill the last pack of
    ``_packed_forward``; below the gate's 512 locations·heads, so through the
    kernel's wrapper directly), at a head dim of 40 and at 48 frames; SDPA
    over the (b, s, h, f, d) permuted view as the library time."""
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    tally = Tally("temporal_attention", "animate_anything_tpu_torch/csrc/temporal_attention.cu",
                  "animate_anything_tpu/ops/temporal_attention.py:97")
    full = [(2, FRAMES + 1, s, h, 64) for s, h in PACKED_SITES]
    ragged = [(1, 17, 33, 2, 64), (2, 14, 40, 1, 32), (2, 2, 40, 1, 32)]
    # a head dim padded to the kernel's next multiple of 16, and f > 32
    padded = [(2, 17, 40, 3, 40), (1, 48, 24, 2, 64)]
    for b, f, s, h, d in full + ragged + padded:
        q, k, v = (torch.randn(b, f, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        with torch.no_grad():
            got = ta.packed_temporal_attention(q, k, v)
            want = ta.temporal_attention_reference(q, k, v)
            tag = f"temporal_attention b={b} f={f} s={s} h={h} d={d}"
            _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
            ms = cuda_ms(lambda: ta.packed_temporal_attention(q, k, v))
            plain = cuda_ms(lambda: ta.temporal_attention_reference(q, k, v), warmup=1, iters=3)
            qp, kp, vp = (x.permute(0, 2, 3, 1, 4) for x in (q, k, v))
            library = cuda_ms(lambda: F.scaled_dot_product_attention(qp, kp, vp))
        tally.add(tag, _err(got, want), ms, plain, 4 * b * s * h * f * f * d,
                  4 * b * f * s * h * d * 2, library)
    return tally.row


def check_packed_flash(gen) -> dict:
    """Row 16, the all-heads flash attention: ``flash_attention`` (kernel 1)
    at the UNet's three spatial self-attention sites and at JAX's test
    shapes, sk = 77 included, on the first and the last two samples."""
    from animate_anything_tpu_torch.ops import flash_attention as fa

    tally = Tally("flash_attention_packed", "animate_anything_tpu_torch/csrc/flash_attention.cu",
                  "animate_anything_tpu/ops/attic/packed_flash.py:121")
    cases = [(2 * (FRAMES + 1), s, s, h) for s, h in FLASH_SITES] + [(2, 256, 256, 5),
                                                                     (1, 300, 77, 2)]
    for b, sq, sk, h in cases:
        q = torch.randn(b, sq, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, sk, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        tag = f"flash_attention_packed b={b} sq={sq} sk={sk} h={h} d=64"
        with torch.no_grad():
            got = fa.flash_attention(q, k, v)
            err = max(_assert_attention(f"{tag} samples {sl.start}:{sl.stop}", got[sl],
                                        fa.attention_reference(q[sl], k[sl], v[sl]))
                      for sl in _first_and_last(b))
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
            plain = cuda_ms(lambda: [fa.attention_reference(q[i:i + 2], k[i:i + 2], v[i:i + 2])
                                     for i in range(0, b, 2)], warmup=1, iters=2)
            library = cuda_ms(lambda: _sdpa(q, k, v))
        tally.add(tag, err, ms, plain, 4 * b * h * sq * sk * 64,
                  2 * b * (sq + sk) * h * 64 * 2, library)
    return tally.row


def check_add_stats(gen) -> dict:
    """Kernel 10 at the resnet -> temporal-conv seams it was built for and at
    JAX's test shape: y must equal the plain add (the same fp32 add and one
    rounding), the sums those of the stored y in another fp32 order, and the
    same in a second run (no atomics). No single PyTorch call adds and sums;
    the three-call composite (add, two reductions) is a reference line."""
    from animate_anything_tpu_torch.ops import add_stats as ad

    tally = Tally("add_with_stats", "animate_anything_tpu_torch/csrc/group_norm.cu",
                  "animate_anything_tpu/ops/attic/add_stats.py:68")
    cfg = 2 * (FRAMES + 1)
    composite_ms = 0.0
    for n, s, c in ((cfg, 4096, 320), (cfg, 1024, 640), (cfg, 256, 1280), (cfg, 64, 1280),
                    (3, 32, 128)):
        x, r = (torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        with torch.no_grad():
            y, (s1, s2) = ad.add_with_stats(x, r, impl="pallas")
            wy, _ = ad.add_stats_reference(x, r)
            tag = f"add_with_stats n={n} s={s} c={c}"
            _assert_close(tag, y, wy, 0.0, 0.0)
            _assert_stored_sums(tag, y, (s1, s2), dim=1)
            _, again = ad.add_with_stats(x, r, impl="pallas")
            if not (torch.equal(again[0], s1) and torch.equal(again[1], s2)):
                raise AssertionError(f"{tag}: the sums differ between two runs")
            ms = cuda_ms(lambda: ad.add_with_stats(x, r, impl="pallas"))
            plain = cuda_ms(lambda: ad.add_stats_reference(x, r))

            def composite():
                yc = x + r
                return yc.float().sum(1), yc.float().square().sum(1)
            comp = cuda_ms(composite)
        composite_ms += comp
        log(f"    three-call composite (add, Σ, Σ²; a reference line) {comp:.3f} ms")
        tally.add(tag, _err(y, wy), ms, plain, 3 * n * s * c, 3 * n * s * c * 2 + 2 * n * c * 4)
    tally.row["composite_ms"] = composite_ms
    return tally.row


def check_ln_qkv(gen) -> dict:
    """Kernels 11 and 1 (``ln_qkv_attention``) at the UNet's three spatial
    self-attention sites (norm1 -> to_q/k/v -> attention) and at JAX's test
    shapes, against the plain version on the first and the last two
    samples. No single
    PyTorch call computes it; the three-call composite (``F.layer_norm``, one
    q|k|v matmul, SDPA) is a reference line."""
    from animate_anything_tpu_torch.ops import ln_qkv_attention as lq

    tally = Tally("ln_qkv_attention", "animate_anything_tpu_torch/csrc/ln_qkv.cu",
                  "animate_anything_tpu/ops/attic/ln_qkv_attention.py:130")
    tally.row["source_also"] = "animate_anything_tpu_torch/csrc/flash_attention.cu"
    n = 2 * (FRAMES + 1)
    composite_ms = 0.0
    for b, s, c, h in ((n, 4096, 320, 5), (n, 1024, 640, 10), (n, 256, 1280, 20),
                       (2, 256, 128, 2), (1, 300, 192, 3)):
        hd = 64 * h
        x = torch.randn(b, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        lns = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        lnb = 0.1 * torch.randn(c, generator=gen, device="cuda")
        ws = [_lecun(gen, c, hd, fan_in=c) for _ in range(3)]
        kw = dict(heads=h, head_dim=64, eps=1e-5)
        tag = f"ln_qkv_attention b={b} s={s} c={c} h={h}"
        with torch.no_grad():
            got = lq.ln_qkv_attention(x, lns, lnb, *ws, impl="pallas", **kw)
            err = max(_assert_attention(f"{tag} samples {sl.start}:{sl.stop}", got[sl],
                                        lq.ln_qkv_attention_reference(x[sl], lns, lnb, *ws, **kw))
                      for sl in _first_and_last(b))
            ms = cuda_ms(lambda: lq.ln_qkv_attention(x, lns, lnb, *ws, impl="pallas", **kw))
            plain = cuda_ms(lambda: [lq.ln_qkv_attention_reference(x[i:i + 2], lns, lnb, *ws, **kw)
                                     for i in range(0, b, 2)], warmup=1, iters=2)
            wqkv = torch.cat(ws, 1)
            lnsb, lnbb = lns.to(x.dtype), lnb.to(x.dtype)

            def composite():
                qkv = F.layer_norm(x, (c,), lnsb, lnbb, 1e-5) @ wqkv
                q, k, v = (t.reshape(b, s, h, 64) for t in qkv.split(hd, -1))
                return _sdpa(q, k, v)
            comp = cuda_ms(composite)
        composite_ms += comp
        log(f"    three-call composite (layer_norm, q|k|v matmul, SDPA; a reference line) "
            f"{comp:.3f} ms")
        flop = 4 * b * h * s * s * 64 + 6 * b * s * c * hd
        nbytes = b * s * (c + hd) * 2 + 3 * c * hd * 2 + 2 * c * 4
        tally.add(tag, err, ms, plain, flop, nbytes)
        torch.cuda.empty_cache()
    tally.row["composite_ms"] = composite_ms
    return tally.row


KERNEL_CHECKS = (check_flash, check_flash_backward, check_geglu, check_tap_conv,
                 check_proj_residual, check_temporal_block, check_channel_sums,
                 check_streaming_gn, check_spatial_conv, check_temporal_attention,
                 check_packed_flash, check_add_stats, check_ln_qkv)


def check_kernels(seed: int = 0) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for check in KERNEL_CHECKS:
        rows.append(check(gen))
        torch.cuda.empty_cache()
    return rows


def kernel_counters() -> dict:
    """Each kernel's launch counter: (module, attribute)."""
    from animate_anything_tpu_torch.ops import (add_stats, flash_attention, geglu, group_norm,
                                                ln_qkv_attention, proj_residual, spatial_conv,
                                                streaming_group_norm, temporal_attention,
                                                temporal_block, temporal_conv)

    return {"flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches"),
            "ln_geglu_ff": (geglu, "launches"), "tap_conv": (temporal_conv, "launches"),
            "proj_residual_stats": (proj_residual, "launches"),
            "temporal_block": (temporal_block, "launches"),
            "channel_sums": (group_norm, "launches"),
            "group_norm_stream": (streaming_group_norm, "launches"),
            "spatial_conv": (spatial_conv, "launches"),
            "temporal_attention": (temporal_attention, "launches"),
            "add_with_stats": (add_stats, "launches"),
            "ln_qkv_attention": (ln_qkv_attention, "launches")}


def reset_counts() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_counters().items()}


def require_launched(path: str, counts: dict, names) -> None:
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")


def require_not_launched(path: str, counts: dict, names) -> None:
    ran = {n: counts[n] for n in names if counts[n] != 0}
    if ran:
        raise AssertionError(f"{path}: kernels of another path launched: {ran}")


FORWARD_KERNELS = ("flash_attention", "ln_geglu_ff", "tap_conv", "proj_residual_stats",
                   "temporal_block")
OPT_IN_KERNELS = ("channel_sums", "group_norm_stream", "spatial_conv")
PACKED_KERNELS = ("temporal_attention",)
# The three functions no model path reaches: their own entry points. Row 16
# (the all-heads flash attention) is kernel 1 through ``flash_attention``, so
# its count is kernel 1's: on the entry points' path, that of its own call.
ENTRY_KERNELS = ("flash_attention_packed", "add_with_stats", "ln_qkv_attention")
ROW_COUNTER = {"flash_attention_packed": "flash_attention"}


def require_only(path: str, counts: dict, names) -> None:
    """The kernels ``names`` launched on ``path``, and no other."""
    require_launched(path, counts, names)
    require_not_launched(path, counts, [n for n in counts if n not in names])


def run_entry_points(seed: int = 0) -> dict:
    """The path of the three functions that no model path reaches: each
    entry point called once at a full-width site of the UNet it was built
    for (the first spatial self-attention level, the 320-wide resnet ->
    temporal-conv seam), its output checked for shape and finite values;
    returns each kernel's launch count during the calls. ``flash_attention``
    counts kernel 1 under both functions that run it; row 16's count is the
    kernel-1 launches of its own call, read right after it."""
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops.add_stats import add_with_stats
    from animate_anything_tpu_torch.ops.ln_qkv_attention import ln_qkv_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, s, c, h = 2 * (FRAMES + 1), 4096, 320, 5
    x, r = (torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q, k, v = (torch.randn(n, s, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lns = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    lnb = 0.1 * torch.randn(c, generator=gen, device="cuda")
    ws = [_lecun(gen, c, 64 * h, fan_in=c) for _ in range(3)]
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        outs = {"flash_attention_packed": fa.flash_attention(q, k, v)}
        row16 = fa.launches
        outs["add_with_stats"] = add_with_stats(x, r, impl="pallas")[0]
        outs["ln_qkv_attention"] = ln_qkv_attention(x, lns, lnb, *ws, heads=h, head_dim=64,
                                                    impl="pallas")
        torch.cuda.synchronize()
    launches = read_counts()
    launches["flash_attention_packed"] = row16
    for name, out in outs.items():
        if not torch.isfinite(out).all():
            raise AssertionError(f"entry point {name}: non-finite output")
    log(f"entry points (n={n} s={s} c={c} heads={h}): launches {launches}")
    require_only("entry points", launches, ENTRY_KERNELS + ("flash_attention",))
    return launches


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
# Its training loss and gradients, bf16 on the card against fp32 on the CPU:
# the loss is a mean over many bf16-rounded outputs; the gradients pass the
# forward's rounding and again the backward's (bf16 cotangents, P and dS
# rounded before their products, bf16 weight gradients), through ~40 layers
# each way.
SMALL_LOSS_REL = 2e-2
SMALL_GRAD_REL_RMS = 1e-1
# The same error per parameter tensor, ‖g_card − g_cpu‖ / ‖g_cpu‖, at its
# worst: the flattened RMS above is ruled by the largest leaves, so a wrong
# scale on one small site's gradients could pass it; this bound does not
# (worst reading 0.081 on the H100; a 1.25x scale on one tensor reads ~0.25).
SMALL_GRAD_WORST_REL = 0.15
# Some gradients are zero by construction: the biases of the temporal convs
# that feed a GroupNorm with one channel per group (32 groups on the tiny
# model's 32-channel levels), which removes any per-channel shift. The CPU
# gives them fp32 rounding noise, so a relative error means nothing there.
# A tensor whose RMS per element is under ZERO_SCALE of the typical
# magnitude (the RMS over every gradient element) counts as zero; the log
# shows the gap between the two classes. It must stay near zero on the
# card: its RMS error per element under SMALL_GRAD_ZERO_NOISE of the typical
# magnitude (worst reading 2.2e-3).
ZERO_SCALE, SMALL_GRAD_ZERO_NOISE = 1e-4, 1e-2


def _small_unet(seed: int, **cfg_kw):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True, attention_head_dim=32,
                            **cfg_kw)
    ref = UNet3DConditionModel(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_unet3d_(ref, gen)
    for name, p in ref.named_parameters():   # wake the zero-initialised convs
        if "conv4.3" in name:
            p.data.normal_(0.0, 0.02, generator=gen)
    return ref.eval(), gen


def check_small_unet(seed: int = 0, attn_impl: str = "pallas") -> float:
    """Under ``"pallas"`` every kernel of the forward must launch; under
    ``"packed"`` kernel 9 (at the sites whose b·s·h reaches 512) and no
    other."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_

    ref, gen = _small_unet(seed, attn_impl=attn_impl)
    cfg = ref.config
    b, f, hw = 2, 3, 16
    sample = torch.randn(b, f, hw, hw, 4, generator=gen)
    cond = torch.randn(b, 1, hw, hw, 4, generator=gen)
    mask = (torch.rand(b, 1, hw, hw, 1, generator=gen) > 0.5).float()
    ctx = torch.randn(b, 77, cfg.cross_attention_dim, generator=gen)
    motion = torch.tensor([3.0, 7.0])
    with torch.no_grad():
        want = ref(sample, 500, ctx, cond, mask, motion)
        gpu = cast_module_(ref.to("cuda"))
        reset_counts()
        got = gpu(sample.cuda(), 500, ctx.cuda(), cond.cuda(), mask.cuda(),
                  motion.cuda()).float().cpu()
    launches = read_counts()
    path = f"small UNet forward (attn_impl={attn_impl!r})"
    if attn_impl == "pallas":
        require_launched(path, launches, FORWARD_KERNELS)
    else:
        require_only(path, launches, PACKED_KERNELS)
    if not torch.isfinite(got).all():
        raise AssertionError("small UNet: non-finite output on the card")
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    log(f"{path}, card (kernels, bf16) vs CPU (plain, fp32): relative RMS {rel:.4g}"
        f" (limit {SMALL_REL_RMS}); launches {launches}")
    if rel > SMALL_REL_RMS:
        raise AssertionError(f"small UNet disagrees with its CPU reference: {rel:.4g}")
    return rel


def grad_errors(want: dict, got: dict) -> tuple[dict, dict, dict]:
    """Per parameter tensor: ‖g_card − g_cpu‖ / ‖g_cpu‖ where the CPU's
    gradient is of the typical magnitude; where it is zero by construction
    (``ZERO_SCALE``), the card's RMS error per element over the typical
    magnitude; and each tensor's RMS per element over the typical one."""
    numel = sum(g.numel() for g in want.values())
    typical = (sum(float(g.square().sum()) for g in want.values()) / numel) ** 0.5
    rel, zero, scale = {}, {}, {}
    for n, g in want.items():
        err, norm, root = float((got[n] - g).norm()), float(g.norm()), g.numel() ** 0.5
        scale[n] = norm / root / typical
        if scale[n] < ZERO_SCALE:
            zero[n] = err / root / typical
        else:
            rel[n] = err / norm
    return rel, zero, scale


def check_small_unet_grads(seed: int = 1) -> float:
    """One training loss and its backward through the small UNet with
    per-sub-layer checkpointing: bf16 on the card through every kernel (the
    flash backward included) against fp32 on the CPU through the plain
    versions, on the same noise, t and text-dropout flag."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.train import make_loss_fn, mask_motion_finetune

    ref, gen = _small_unet(seed, gradient_checkpointing=True)
    b, f, hw = 2, 3, 16
    batch = {"latents": torch.randn(b, f, hw, hw, 4, generator=gen),
             "mask": torch.zeros(b, 8 * hw, 8 * hw),
             "encoder_hidden_states": torch.randn(b, 77, ref.config.cross_attention_dim,
                                                  generator=gen),
             "uncond_hidden_states": torch.zeros(b, 77, ref.config.cross_attention_dim)}
    batch["mask"][:, 32:96, 16:112] = 255.0
    noise = torch.randn(b, f, hw, hw, 4, generator=gen)
    t, drop = torch.tensor([123, 777]), False
    config, schedule = mask_motion_finetune()
    loss_fn = make_loss_fn(schedule, config)

    loss_cpu, _ = loss_fn(ref, batch, noise, t, drop)
    loss_cpu.backward()
    want = {n: p.grad.clone() for n, p in ref.named_parameters() if p.grad is not None}

    gpu = cast_module_(copy.deepcopy(ref).to("cuda"))
    gpu.zero_grad(set_to_none=True)
    reset_counts()
    loss_gpu, _ = loss_fn(gpu, {k: v.cuda() for k, v in batch.items()}, noise.cuda(),
                          t.cuda(), drop)
    loss_gpu.backward()
    torch.cuda.synchronize()
    launches = read_counts()
    require_only("small UNet training step", launches,
                 FORWARD_KERNELS + ("flash_attention_bwd",))

    params = dict(gpu.named_parameters())
    got = {n: (torch.zeros(g.shape) if params[n].grad is None else params[n].grad.float().cpu())
           for n, g in want.items()}
    if not all(torch.isfinite(g).all() for g in got.values()):
        raise AssertionError("small UNet: non-finite gradients on the card")
    per, zero, scale = grad_errors(want, got)
    missing = [n for n in per if float(got[n].abs().max()) == 0.0]
    if missing:
        raise AssertionError(f"small UNet: no gradient on the card for {missing[:8]} "
                             f"({len(missing)} parameters)")
    g_cpu = torch.cat([want[n].flatten() for n in want])
    g_gpu = torch.cat([got[n].flatten() for n in want])
    rel = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    worst = sorted(per, key=per.get, reverse=True)
    worst_zero = max(zero.values(), default=0.0)
    loss_gpu, loss_cpu = float(loss_gpu.detach()), float(loss_cpu.detach())
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    log(f"small UNet training loss + backward (checkpointed), card (kernels, bf16) vs CPU "
        f"(plain, fp32): loss {loss_gpu:.6g} vs {loss_cpu:.6g} (relative "
        f"{loss_rel:.3g}, limit {SMALL_LOSS_REL}); gradient relative RMS {rel:.4g} over "
        f"{len(want)} parameters (limit {SMALL_GRAD_REL_RMS}); per parameter, worst "
        f"{per[worst[0]]:.4g} (limit {SMALL_GRAD_WORST_REL}; "
        + ", ".join(f"{n} {per[n]:.3g}" for n in worst[:3])
        + f"; median {per[worst[len(worst) // 2]]:.3g}); {len(zero)} zero by construction "
        f"(magnitude up to {max((scale[n] for n in zero), default=0.0):.3g} of the typical, "
        f"the others from {min(scale[n] for n in per):.3g}), worst error {worst_zero:.3g} of "
        f"the typical magnitude (limit {SMALL_GRAD_ZERO_NOISE}); launches {launches}")
    if (loss_rel > SMALL_LOSS_REL or rel > SMALL_GRAD_REL_RMS
            or per[worst[0]] > SMALL_GRAD_WORST_REL or worst_zero > SMALL_GRAD_ZERO_NOISE):
        raise AssertionError(f"small UNet training step disagrees with its CPU reference: "
                             f"loss {loss_rel:.4g}, gradients {rel:.4g}, worst parameter "
                             f"{worst[0]} {per[worst[0]]:.4g}, zero gradients {worst_zero:.4g}")
    return rel


def build_models(seed: int = 0, gradient_checkpointing: bool = False):
    """Full-width UNet, VAE and CLIP text encoder in the policy's dtypes."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextModel
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.utils.convert import init_clip_text_, init_unet3d_, init_vae_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        unet = UNet3DConditionModel(UNet3DConfig(motion_mask=True, motion_strength=True,
                                                 gradient_checkpointing=gradient_checkpointing))
        vae = AutoencoderKL(VAEConfig())
        text = CLIPTextModel()
    for module, init in ((unet, init_unet3d_), (vae, init_vae_), (text, init_clip_text_)):
        cast_module_(init(module, gen)).eval()
    count = lambda m: sum(p.numel() for p in m.parameters())
    log(f"unet: {count(unet) / 1e9:.3f} B params, vae: {count(vae) / 1e6:.1f} M, "
        f"CLIP text: {count(text) / 1e6:.1f} M (bf16 weights)")
    return unet, vae, text


def build_pipeline(seed: int = 0):
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    unet, vae, text = build_models(seed)
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


def run_requests(pipe) -> dict:
    """Drive the inference path; return each kernel's launch count during it."""
    reqs = make_requests()
    log(f"requests: {REQUESTS} x animate_image({RES}x{RES}, {FRAMES} frames, "
        f"{STEPS} DPM-Solver++ steps, CFG {GUIDANCE})")
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    launches = read_counts()
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"kernel launches during the requests: {launches}")
    require_only("requests", launches, FORWARD_KERNELS)
    decode_peak(pipe, latents)
    return launches


def decode_peak(pipe, latents) -> None:
    """The request's last phase alone: the peak device memory of one 16-frame
    VAE decode of its latents, with the pipeline's weights resident as
    during the request, and the SDPA backend that takes its mid-block
    attention and the CLIP text encoder's (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    from animate_anything_tpu_torch.models.vae import decode_video

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        decode_video(pipe.vae, latents)
    torch.cuda.synchronize()
    log(f"  the 16-frame VAE decode alone: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    names = {int(v): k for k, v in SDPBackend.__members__.items()}
    for what, shape, causal in (("VAE mid-block, one 512-wide head", (FRAMES, 1, 4096, 512), False),
                                ("CLIP text, 16 heads x 64, causal", (2, 16, 77, 64), True)):
        x = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
        choice = names.get(int(torch._fused_sdp_choice(x, x, x, is_causal=causal)), "?")
        log(f"  SDPA backend for the {what} {shape}: {choice}")


def run_opt_in_request(pipe) -> dict:
    """One request in the opt-in configuration, then its latents decoded in
    both configurations; return each kernel's launch count during the
    request."""
    from animate_anything_tpu_torch.models.vae import decode_video
    from animate_anything_tpu_torch.ops.spatial_conv import opt_in_config

    req = make_requests(seed=1)[0]
    log(f"opt-in request: animate_image({RES}x{RES}, {FRAMES} frames, {STEPS} DPM-Solver++ "
        f"steps, CFG {GUIDANCE}) with the streaming GroupNorm, the channel-sums statistics "
        f"and AA_SPATIAL_CONV=1")
    gen = torch.Generator(device="cuda").manual_seed(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with opt_in_config():
        t0 = time.perf_counter()
        video, latents = pipe.animate_image(
            num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
            generator=gen, **req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_counts()
    if tuple(video.shape) != (1, FRAMES, RES, RES, 3):
        raise AssertionError(f"opt-in request: video shape {tuple(video.shape)}")
    if not torch.isfinite(video).all() or not torch.isfinite(latents).all():
        raise AssertionError("opt-in request: non-finite output")
    log(f"  opt-in request: {dt:.3f} s  video {tuple(video.shape)} {video.dtype} "
        f"range [{float(video.min()):.3f}, {float(video.max()):.3f}]")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  kernel launches during the opt-in request: {launches}")
    require_only("opt-in request", launches, FORWARD_KERNELS + OPT_IN_KERNELS)

    with torch.no_grad():
        default = decode_video(pipe.vae, latents).float()
        with opt_in_config():
            opt_in = decode_video(pipe.vae, latents).float()
    if not torch.isfinite(opt_in).all():
        raise AssertionError("opt-in VAE decode: non-finite output")
    rel = float((opt_in - default).square().mean().sqrt() / default.square().mean().sqrt())
    log(f"  VAE decode of the opt-in request's latents, opt-in vs default configuration: "
        f"relative RMS {rel:.4g} (limit {DECODE_REL_RMS}), max |diff| "
        f"{_err(opt_in, default):.4g} over a range of "
        f"[{float(default.min()):.3f}, {float(default.max()):.3f}]")
    if rel > DECODE_REL_RMS:
        raise AssertionError(f"opt-in VAE decode disagrees with the default one: {rel:.4g}")
    return launches


def run_packed_request(pipe) -> dict:
    """The first default request (same image, mask, strength, prompt and
    generator seed) with the UNet under ``attn_impl="packed"`` (the same
    weights, shared); return each kernel's launch count during it. The
    pipeline keeps the packed UNet."""
    req = make_requests()[0]
    pipe.unet = pipe.unet.with_attn_impl("packed")
    log(f"packed request: animate_image({RES}x{RES}, {FRAMES} frames, {STEPS} DPM-Solver++ "
        f"steps, CFG {GUIDANCE}) with UNet3DConfig(attn_impl='packed')")
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    video, latents = pipe.animate_image(
        num_frames=FRAMES, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=gen, **req)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    if tuple(video.shape) != (1, FRAMES, RES, RES, 3):
        raise AssertionError(f"packed request: video shape {tuple(video.shape)}")
    if not torch.isfinite(video).all() or not torch.isfinite(latents).all():
        raise AssertionError("packed request: non-finite output")
    log(f"  packed request: {dt:.3f} s  video {tuple(video.shape)} {video.dtype} "
        f"range [{float(video.min()):.3f}, {float(video.max()):.3f}]")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  kernel launches during the packed request: {launches}")
    require_only("packed request", launches, PACKED_KERNELS)
    want = PACKED_PER_FORWARD * STEPS
    if launches["temporal_attention"] != want:
        raise AssertionError(f"packed request: kernel 9 launched "
                             f"{launches['temporal_attention']} times, not {want}")
    compare_packed_xla(pipe.unet)
    return launches


def compare_packed_xla(packed_unet, seed: int = 3) -> float:
    """One full-width CFG forward (2 x 16 frames, 64x64 latents) of the same
    weights under "packed" and under "xla": they differ only in the
    frame-attention core. The "xla" forward launches no kernel."""
    xla_unet = packed_unet.with_attn_impl("xla")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, FRAMES, 64, 64, 4, generator=gen, device="cuda")
    cond = torch.randn(2, 1, 64, 64, 4, generator=gen, device="cuda")
    mask = (torch.rand(2, 1, 64, 64, 1, generator=gen, device="cuda") > 0.5).float()
    emb = torch.randn(2, 77, 1024, generator=gen, device="cuda")
    motion = torch.tensor([5.0, 5.0], device="cuda")
    with torch.no_grad():
        packed = packed_unet(x, 500, emb, cond, mask, motion).float()
        torch.cuda.synchronize()
        reset_counts()
        xla = xla_unet(x, 500, emb, cond, mask, motion).float()
        torch.cuda.synchronize()
    launches = read_counts()
    require_not_launched("xla forward", launches, list(launches))
    if not torch.isfinite(packed).all() or not torch.isfinite(xla).all():
        raise AssertionError("packed vs xla forward: non-finite output")
    rel = float((packed - xla).square().mean().sqrt() / xla.square().mean().sqrt())
    log(f"  one CFG forward, attn_impl='packed' vs 'xla' (same weights and inputs): relative "
        f"RMS {rel:.4g} (limit {PACKED_VS_XLA_REL_RMS}), max |diff| {_err(packed, xla):.4g}")
    if rel > PACKED_VS_XLA_REL_RMS:
        raise AssertionError(f"packed forward disagrees with the xla forward: {rel:.4g}")
    return rel

def make_train_batch(seed: int = 0) -> dict:
    """One 512x512 / 16-frame clip (a random image drifting 4 px a frame),
    a motion mask over half of it, the prompt's ids (hash tokenizer) and the
    empty prompt's for the text dropout."""
    import numpy as np

    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (RES, RES, 3)).astype(np.float32)
    video = np.stack([np.roll(base, 4 * i, axis=1) for i in range(FRAMES)])[None]
    mask = np.zeros((1, RES, RES), np.float32)
    mask[:, RES // 4:3 * RES // 4, :] = 255.0
    tok = HashTokenizer()
    return {"pixel_values": torch.from_numpy(video), "mask": torch.from_numpy(mask),
            "prompt_ids": torch.from_numpy(tok(TRAIN_PROMPT).input_ids).long(),
            "uncond_ids": torch.from_numpy(tok("").input_ids).long()}


def run_train_steps() -> dict:
    """Drive the training path at full width; return each kernel's launch
    count during the timed steps."""
    from animate_anything_tpu_torch.train import (create_train_state, make_train_step,
                                                  mask_motion_finetune)

    unet, vae, text = build_models(gradient_checkpointing=True)
    for module in (vae, text):
        module.requires_grad_(False)
    config, schedule = mask_motion_finetune()
    state = create_train_state(unet, config)
    step = make_train_step(schedule, config, vae=vae, text_encoder=text)
    batch = make_train_batch()
    gen = torch.Generator(device="cuda").manual_seed(11)
    log(f"training: 1 + {TRAIN_STEPS} steps of the full-width UNet, batch 1 x {FRAMES} frames "
        f"x {RES}x{RES} (VAE encode + CLIP text in the step, per-sub-layer checkpointing, "
        f"AdamW lr {config.learning_rate} on fp32 masters)")
    before = {n: float(m.double().sum()) for n, m in state.masters.items()}
    t0 = time.perf_counter()
    metrics = step(state, batch, gen)
    log(f"  warm-up step: {time.perf_counter() - t0:.3f} s  {metrics}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f"  step {i}: {times[-1]:.3f} s  " + "  ".join(
            f"{k} {v:.6g}" for k, v in metrics.items()))
        bad = {k: v for k, v in metrics.items() if not v == v or abs(v) == float("inf")}
        if bad:
            raise AssertionError(f"train step {i}: non-finite {bad}")
    launches = read_counts()
    changed = sum(float(m.double().sum()) != before[n] for n, m in state.masters.items())
    log(f"  s/step {sum(times) / len(times):.3f} (steps {', '.join(f'{t:.3f}' for t in times)})")
    log(f"  peak device memory over the timed steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  fp32 masters changed: {changed} of {len(before)} parameter tensors")
    log(f"  kernel launches during the {TRAIN_STEPS} timed steps: {launches}")
    if changed == 0:
        raise AssertionError("training: no parameter changed")
    require_only("training", launches, FORWARD_KERNELS + ("flash_attention_bwd",))
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
    check_attention_gates(torch.Generator(device="cuda").manual_seed(5))
    entry = run_entry_points()
    log("temporal transformers, fused vs composite path (bf16, b=2, f=17):")
    time_temporal_paths()
    check_small_unet()
    check_small_unet(attn_impl="packed")
    check_small_unet_grads()

    pipe = build_pipeline()
    requests = run_requests(pipe)
    opt_in = run_opt_in_request(pipe)
    packed = run_packed_request(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train_steps()
    own_path = {"flash_attention_bwd": train, **{n: opt_in for n in OPT_IN_KERNELS},
                **{n: packed for n in PACKED_KERNELS}, **{n: entry for n in ENTRY_KERNELS}}
    for row in rows:
        name = row["name"]
        counter = ROW_COUNTER.get(name, name)
        row["launches"] = own_path.get(name, requests)[name]
        for label, counts in (("requests", requests), ("opt_in", opt_in), ("packed", packed),
                              ("entry_points", entry), ("train", train)):
            row[f"launches_{label}"] = counts.get(name, counts[counter])

    print(json.dumps({"kernels": rows}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
