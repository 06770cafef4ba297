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
   ragged s), each of the two called twice: kernel 5, and kernel 3's y and
   fixed-order sums, bit for bit; the gates that
   send the head sizes the forward does not take to SDPA or the einsum form
   and the widths past kernel 2's reach (c > 4096) to its lean composite,
   with kernel 2 at widths off 16, off 8 (zero-padded) and past 1280; the
   channel sums (kernel 6) at every statistics site of the opt-in forward,
   called twice (bit for bit) and summed over a CFG forward by the sites'
   counts, and the one-pass GroupNorm (+SiLU; kernel 7) at every GroupNorm
   site of the VAE's 512 px image encode and 16-frame decode, called twice
   (bit for bit), one launch a call, by events and by device time, summed
   over an encode and a decode by the sites' counts; the fused GroupNorm-affine + SiLU -> 3x3 conv
   (kernel 8) at every resnet stage of the opt-in forward beside its bf16
   composite (affine + SiLU, cuDNN's conv2d, + bias (+ residual)), summed
   over a CFG forward by the stages' counts, at JAX's test shapes and at W >
   64, called twice (bit for bit, the channels_last weight read in place);
   the projection + residual + sums (kernel 4) at its five sites beside its
   bf16 composite and its profiled device time, summed likewise, and at
   ragged s, called twice; then kernels 1, 2, 3 and 5 at the SVD UNet's
   sites (``check_sites(..., "svd", ...)``: b·f = 28, 14 frames; kernel 3 on the
   GroupNorm fold at eps 1e-6, with and without the residual), each called
   twice and timed beside its bound, summed over an SVD CFG forward by the
   sites' counts; times one temporal
   transformer per width on its fused path (kernel 5 + kernel 2) against
   the composite path;
4. runs a small UNet on the card through the kernels (every temporal site on
   the fused path) and holds it against the same weights through the plain
   versions on the CPU: its forward, then one training loss and its
   backward with gradient checkpointing (every parameter's gradient); and a
   small SVD UNet (14 frames, 9 channels) likewise, its forward through
   kernels 1, 2, 3 and 5;
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
8. frees that pipeline and drives the ``train.py --eval`` entry point of
   the port (``animate_anything_tpu_torch.cli.main_eval``) at
   ``configs/train_mask_motion.yaml`` (random weights, the checkpoint
   directory being absent): twice in memory (the two videos within
   ``EVAL_RUN_TO_RUN`` and bit-equal), then its weights through ``save_pipeline`` (fp32)
   and back, the models built from that directory equal to the in-memory
   ones bit for bit, ``main_eval`` on that directory, and one 4-step DDIM
   request on the same weights; every request launches kernels 1-5 and no
   other. Then one CFG forward of those weights twice on the same inputs,
   and once with every kernel launched twice a call, every pair bit-equal;
9. drives the SVD serving path (``run_svd_entry``): ``cli_svd.main_eval``
   at ``configs/train_svd_mask.yaml`` (9 channels, ``attn_impl: pallas``,
   512 px, 14 frames, 25 Euler steps, decode chunk 7, bf16, seeded random
   weights) twice, each launching kernels 1, 2, 3 and 5 exactly 375, 1200,
   1100 and 400 times and no other, with its build seconds, request seconds
   and peak memory; one v2v request (``TextStableVideoDiffusionPipeline`` on
   a synthetic 14-frame video's condition latents) with the same counts; one
   full-width CFG forward under "pallas" against "xla" on the same weights;
   then frees those models;
10. trains the same full-width UNet on one
   512x512 / 16-frame clip (the ``configs/train_mask_motion.yaml`` values):
   the VAE encode and CLIP text inside the step, per-sub-layer gradient
   checkpointing, AdamW on fp32 masters; 1 warm-up step and 3 timed steps,
   which launch none of kernels 6-11;
11. drives the training entry points of the port (``run_train_entry``) on
   synthetic clips (frame directories of PNGs written under ``build/``):
   ``train_lora`` at ``configs/train_mask_motion_lora.yaml`` (batch 4, 6
   steps, checkpoints at 3 and 6, the step-5 preview), resumed from its
   ``ckpt/`` to step 8, ``main_eval`` on its step-6 adapter file, and
   ``train.py`` at ``configs/train_mask_motion.yaml`` (batch ``FULL_BATCH``,
   2 steps with the checkpoint and pipeline writes, then 1 step with the
   8-bit AdamW), each launching kernels 1-5 and the flash backward and no
   other (the eval: kernels 1-5);
12. drives the stage-2 entry point (``run_stage2_entry``:
   ``cli_stage2.main_eval`` at ``configs/layerdiffuse_stage2_384.yaml`` with
   ``attn_impl=pallas``; 384 px, 8 frames, the LayerDiffuse pair's RGBA
   decode, the gif and two webps) twice, bit-equal, kernels 1-5 at exactly
   25 CFG forwards' worth each run and no other, then the 9-channel Concat
   pipeline
   through a ``unet/config.json`` with ``condition_mode: channel_concat``;
   and, after step 11, SVD training (``run_svd_train_entry``: ``train_svd``
   without ``--eval`` at ``configs/train_svd_mask.yaml``, batch 3, 14 frames,
   512 px, gradient checkpointing, 3 steps on synthetic clips, the
   checkpoint and ``unet/`` written once and the latter read back bit for
   bit), each step launching kernels 1, 2, 3, 5 and the flash backward and
   no other;
12b. after step 12's stage 2, the serving path (``run_serving_paths``):
   ``serving.VideoServer`` over HTTP on 127.0.0.1 (an ephemeral port)
   fronting the ``app.py`` controller at ``configs/train_mask_motion.yaml``
   and the ``app_svd.py`` one at ``configs/train_svd_mask.yaml`` (full
   width, bf16, attn_impl pallas), three 512 px / 16-frame / 25-step / CFG 9
   mask+motion requests (two with one seed: byte-equal gifs) and one SVD
   request, every job ``done`` with its exact launches; a default PAB
   request and an SVD PAB request on the first requests' inputs (launches
   exact, latent PSNR and motion-score drift against the exact latents); a
   27-frame long video in two chunks; one CFG forward under a prompt-to-
   prompt ``AttentionStore`` at 256 px and 8 frames;
13. checks that every kernel was launched on each path that runs it, prints
   one JSON line with the kernels' numbers (``launches``: the count on the
   path of the slice that brought the kernel in, the requests for kernels
   1-5, the training steps for the flash backward, the opt-in request for
   kernels 6-8, the packed request for kernel 9, and for the three functions
   that no model path reaches (the all-heads flash attention through kernel
   1, the add with its sums, kernel 10, and LayerNorm -> q/k/v -> attention,
   kernels 11 and 1) the run of those entry points at full width;
   ``launches_requests``, ``launches_opt_in``, ``launches_packed``,
   ``launches_entry_points``, ``launches_eval``, ``launches_svd`` (the
   first SVD ``main_eval``), ``launches_train``,
   ``launches_train_entry`` (the LoRA run with its preview),
   ``launches_train_full`` (the full finetune at its YAML),
   ``launches_stage2`` (the first stage-2 ``main_eval``),
   ``launches_svd_train`` (the SVD training run), ``launches_server`` and
   ``launches_server_svd`` (the server's first job of each family),
   ``launches_pab``, ``launches_pab_svd``, ``launches_long_video`` and
   ``launches_ptp`` each path's; for kernels
   1, 2, 3 and 5 their SVD sites' ``svd_ms``, ``svd_plain_ms``,
   ``svd_bound_ms``, ``svd_forward_ms`` and ``svd_forward_bound_ms``, for
   kernels 1-5 the same ``stage2_*`` numbers at the stage-2 request's sites,
   for the flash backward ``svd_train_*`` at the SVD training step's b·f =
   42; under ``modes`` the frame and tensor axes' kernel modes, each beside
   its plain version, bound and launches: kernel 3 on one rank's half of
   the positions with all 17 frames (``positions``), kernel 2's row-parallel
   GEMM without bias and residual (``partial``), kernel 5 on half the heads
   in that mode (``heads``)), and last the device line.

After step 11's SVD training a one-rank NCCL process group (a
``FileStore`` in ``build/``) starts: ``run_zero_train_steps`` takes the full-width train step (batch 1,
16 frames, 512 px, ``attn_impl="pallas"``) 3 times without a mesh, then 3
times from the same weights through the ZeRO path on the ``{data: -1}``
mesh: losses, fp32 masters and AdamW moments bit-equal, kernel launches
equal (``launches_zero``), the collectives' time (none at one rank) and
this rank's optimizer bytes printed; then ``run_zero_entry`` runs
``train.py`` at the YAML's own ``mesh: {data: -1}`` inside that group (one
8-bit step and its checkpoint through the ZeRO path, ``launches_zero_entry``);
step 11's entry points run before the group, as a single-card user runs
them. After them:
LaMa at full width (``run_lama``: 16 frames at 512 px through
``inpaint_video``, pixels outside the mask exact, frame 0 against the CPU,
seconds, frames/s and peak memory, then the CLI on a gif with a
``best.ckpt``-layout file, its gif byte-equal to ``inpaint_video``'s),
``compress_video`` (``frames`` and ``folder_json`` on a gif, the shard read
back bit-equal), and where two or more cards exist, 2 NCCL ranks for a
global-batch-2 step and a sharded batch-2 request against one card's (the
first update's sign and relative RMS, each side's s/step), then
``dryrun_multichip(2)`` (``run_multi_gpu``; it prints what ran). The frame
and tensor axes: inside the one-rank group the default
request on a ``{data: 1, frame: 1, tensor: 1}`` mesh, through the frame
path's all-to-alls and sums, bit-equal to the request without a mesh
(``run_axes_one_rank``); where two or more cards exist the default request
on ``{frame: 2}`` and the full-width batch-1 train step on ``{tensor: 2}``
against one card's, timed, the mesh's two same-seed requests bit-equal;
with four, the request on ``{frame: 2, tensor: 2}`` and
``dryrun_multichip(4)``; with eight, ``dryrun_multichip(8)``
(``run_axes_multi_gpu``; at one card it logs that they were skipped).

Steps 3 and 4 also check kernel 9 against its plain version at the packed
configuration's frame-attention shapes (summed over a packed CFG forward by
the sites' counts), at JAX's ragged test shapes and at the edges of its
reach (head dims 40 to 256, 48 and 128 frames, a ragged s), each called
twice (bit for bit), the three entry points' kernels at full-width and JAX's test shapes
(LayerNorm -> q/k/v -> attention called twice, bit for bit, its device time
split between kernels 11 and 1 beside the LayerNorm + q|k|v matmul
composite of kernel 11's half), and a small UNet's forward under
``attn_impl="packed"`` on the card against the CPU; then kernels 1-5 at the
stage-2 request's sites (``check_sites(..., "stage2", ...)``: b·f = 18, 9
frames, s = 2304 / 576 / 144 / 36), the flash backward at b·f = 42 and the
SVD blocks' gradients with the kernels against their plain versions
(``check_svd_site_grads``), and a small SVD UNet's gradients with
checkpointing on against off and their peak memories
(``check_svd_checkpointing``).

Exits non-zero without a CUDA device, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import subprocess
import sys
import time
from typing import Optional

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
# Σy / Σy² epilogues: the kernels add in another order than the plain
# version, and a different accumulation order can flip a bf16 rounding of y
# by one ulp (≤ 2^-7·|y|) at a few of the s rows of a column.
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
# Kernel 9's launches a UNet forward by site: 17 temporal transformers x 2
# frame attentions (transformer_in; 5 transformers at each of the 64², 32²
# and 16² levels; the mid block).
PACKED_SITE_CALLS = (2, 10, 10, 10, 2)
PACKED_PER_FORWARD = sum(PACKED_SITE_CALLS)
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


MODE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def attach_mode(row: dict, mode: str, tally: Tally, counter: str) -> None:
    """A kernel mode's numbers (its own ``Tally``, summed over its shapes)
    under the kernel's row as ``row["modes"][mode]``; its launches are read
    from ``counter`` (``kernel_counters``) on the paths that take the mode,
    after they ran (``fill_mode_launches``)."""
    row.setdefault("modes", {})[mode] = {**{k: tally.row[k] for k in MODE_KEYS},
                                         "counter": counter, "launches": 0}


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
    """Shapes the kernels do not take run without raising through their
    gates: ``attention(impl="pallas")`` sends d % 16 == 8 and d > 256 to SDPA
    (no kernel-1 launch) and takes kernel 1 at d = 96; ``temporal_attention``
    under ``"packed"`` takes kernel 9 at d = 160 and keeps the einsum form
    above d = 256 (no kernel-9 launch); ``ln_geglu_ff`` takes kernel 2 at
    widths off 16 (600) and off 8 (100, 36: zero-padded), past 1280 (1536,
    2048, 2432: the 16-chunk LayerNorm) and at ``MAX_C`` (4096), and the lean
    composite past it (4104, no kernel-2 launch). Each output against its
    plain version."""
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops import geglu
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
    for d, kernel in ((160, True), (320, False)):
        q, k, v = (torch.randn(1, 17, 64, 8, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        before = ta.launches
        with torch.no_grad():
            got = ta.temporal_attention(q, k, v, impl="packed")
        ran = ta.launches - before
        _assert_close(f"temporal_attention d={d}", got, ta.temporal_attention_reference(q, k, v),
                      Y_ATOL, Y_RTOL)
        if ran != int(kernel):
            raise AssertionError(f"temporal_attention d={d}: kernel 9 launched {ran} times")
        log(f"  temporal_attention(impl='packed') d={d}: "
            f"{'kernel 9' if kernel else 'einsum form, no kernel 9'}")
    for c in (600, 100, 36, 1536, 2048, 2432, geglu.MAX_C, geglu.MAX_C + 8):
        args = _geglu_args(gen, 300, c)
        kernel = geglu.kernel_ok(c)
        before = geglu.launches
        with torch.no_grad():
            got = geglu.ln_geglu_ff(*args)
            again = geglu.ln_geglu_ff(*args)
        ran = geglu.launches - before
        want = geglu.ln_geglu_reference(*args, 1e-5)
        _assert_close(f"ln_geglu_ff c={c}", got, want, Y_ATOL, Y_RTOL)
        if ran != 2 * kernel or not torch.equal(got, again):
            raise AssertionError(f"ln_geglu_ff c={c}: kernel 2 launched {ran} times in two "
                                 f"calls, or the calls differ")
        log(f"  ln_geglu_ff c={c}: {'kernel 2' if kernel else 'lean composite, no kernel 2'}, "
            f"max|err| {_err(got, want):.3g}")
        del args, got, again, want
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
    attach_mode(tally.row, "partial", check_geglu_partial(gen), "ln_geglu_ff.partial")
    return tally.row


def check_geglu_partial(gen) -> Tally:
    """Kernel 2's partial mode (tensor parallelism, ``parallel/tensor.py``)
    at the five shapes on rank 0's slice of a tensor-2 split: the val and
    gate rows of half the hidden columns side by side, their half of W2, no
    b2 and no residual; called twice (bit for bit)."""
    from animate_anything_tpu_torch.ops import geglu
    from animate_anything_tpu_torch.parallel.tensor import TPGroup, local_slice

    tally = Tally("ln_geglu_ff.partial", "animate_anything_tpu_torch/csrc/geglu.cu",
                  "animate_anything_tpu/ops/geglu.py:116")
    tp = TPGroup(2, 0)
    for n, c in GEGLU_SHAPES:
        x, s, b, w1, b1, w2, _ = _geglu_args(gen, n, c)
        args = (x, s, b, local_slice(w1, 0, True, tp).contiguous(),
                local_slice(b1, 0, True, tp).contiguous(),
                local_slice(w2, 1, False, tp).contiguous(), None)
        del w1, w2
        tag = f"ln_geglu_ff partial n={n} c={c} inner={2 * c}"
        got = geglu.ln_geglu_ff(*args, partial=True)
        again = geglu.ln_geglu_ff(*args, partial=True)
        want = geglu.ln_geglu_reference(*args, 1e-5, partial=True)
        _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        ms = cuda_ms(lambda: geglu.ln_geglu_ff(*args, partial=True))
        plain = cuda_ms(lambda: geglu.ln_geglu_reference(*args, 1e-5, partial=True), warmup=1,
                        iters=3)
        inner = 2 * c
        nbytes = 2 * n * c * 2 + 3 * inner * c * 2 + (2 * inner + 2 * c) * 4
        tally.add(tag, _err(got, want), ms, plain, 6 * n * c * inner, nbytes)
        del args, got, again, want
        torch.cuda.empty_cache()
    return tally


# Kernel 3 at the UNet's four temporal-conv sites (``utils/kernel_sites.
# TAP_CONV_SITES``), then at the JAX package's test shape (tests/test_ops.py:
# 2 x 5 frames x 24 locations, 128 -> 128) and at edges of the kernel's
# reach: ragged s (sub-tiles of 64 rows cut by the slab), cin % 64 == 32,
# cin = 32, one frame (both outer taps past the ends), cout < 64.
TAP_CONV_TEST_SHAPES = ((2, 5, 24, 128, 128), (1, 3, 100, 96, 40), (2, 5, 200, 32, 128),
                        (1, 1, 70, 64, 64), (2, 4, 16, 64, 64))
# Two identical calls of kernels 3 and 4 return the same bits: y, and Σy, Σy²,
# whose 64-row partials the kernels add in one fixed order (sub-tile order,
# ``gemm.cuh``'s ``slab_sums``), whatever order the tiles finish in.


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


def _require_same_bits(tag: str, first, again) -> None:
    """Two identical calls' (y, (Σy, Σy²)) equal bit for bit."""
    for name, u, v in zip(("y", "Σy", "Σy²"), (first[0], *first[1]), (again[0], *again[1])):
        if not torch.equal(u, v):
            raise AssertionError(f"{tag}: two identical calls give different {name}")


def _tap_conv_case(tag: str, x, a, b, w, bias, residual) -> float:
    """Kernel 3 against its plain version, and a second call against the
    first: y, Σy and Σy² bit for bit."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    y, (s1, s2) = first = tc.tap_conv(x, a, b, w, bias, residual)
    again = tc.tap_conv(x, a, b, w, bias, residual)
    wy, (w1, w2) = tc.tap_conv_reference(x, a, b, w, bias, residual)
    _assert_close(tag, y, wy, Y_ATOL, Y_RTOL)
    _assert_close(tag + " Σy", s1, w1, SUM_ATOL, SUM_RTOL)
    _assert_close(tag + " Σy²", s2, w2, SUM_ATOL, SUM_RTOL)
    _assert_stored_sums(tag, y, (s1, s2), dim=2)
    _require_same_bits(tag, first, again)
    return _err(y, wy)


def check_tap_conv(gen) -> dict:
    """Kernel 3 at the main path's four sites, each with and without the
    residual, called twice; timed beside the bf16 composite
    (``composite_ms``), then at JAX's test shape and the edges of its reach."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc
    from animate_anything_tpu_torch.utils.kernel_sites import TAP_CONV_SITES

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
    attach_mode(tally.row, "positions", check_tap_conv_positions(gen), "tap_conv.positions")
    return tally.row


def check_tap_conv_positions(gen) -> Tally:
    """Kernel 3 as a frame split runs it (``parallel/frame.py``): every one
    of the 17 frames of rank 0's share of the positions of a frame-2 split
    (⌈s/2⌉), its Σ/Σ² per (b, f) over those positions (the caller sums them
    over the group), at the four sites, with the residual, called twice."""
    from animate_anything_tpu_torch.ops import temporal_conv as tc
    from animate_anything_tpu_torch.parallel.frame import split_counts
    from animate_anything_tpu_torch.utils.kernel_sites import TAP_CONV_SITES

    tally = Tally("tap_conv.positions", "animate_anything_tpu_torch/csrc/temporal_conv.cu",
                  "animate_anything_tpu/ops/temporal_conv.py:159")
    bsz, f = 2, FRAMES + 1
    for s_all, c in TAP_CONV_SITES:
        s = split_counts(s_all, 2)[0]
        x, a, b, w, bias, res = _tap_conv_args(gen, bsz, f, s, c, c)
        tag = f"tap_conv positions bsz={bsz} f={f} s={s} of {s_all} c={c}"
        err = _tap_conv_case(tag, x, a, b, w, bias, res)
        ms = cuda_ms(lambda: tc.tap_conv(x, a, b, w, bias, res))
        plain = cuda_ms(lambda: tc.tap_conv_reference(x, a, b, w, bias, res), warmup=1, iters=3)
        rows = bsz * f * s
        nbytes = 3 * rows * c * 2 + 3 * c * c * 2 + 2 * bsz * f * c * 4
        tally.add(tag, err, ms, plain, 2 * bsz * s * (3 * f - 2) * c * c, nbytes)
        del x, res
        torch.cuda.empty_cache()
    return tally


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
    first: y, Σy and Σy² bit for bit."""
    from animate_anything_tpu_torch.ops import proj_residual as pr

    h = torch.randn(n, s, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = _lecun(gen, c, k, fan_in=k)
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    r = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
    y, (s1, s2) = first = pr.proj_residual_stats(h, w, bias, r)
    again = pr.proj_residual_stats(h, w, bias, r)
    wy, (w1, w2) = pr.proj_residual_reference(h, w, bias, r)
    tag = f"proj_residual n={n} s={s} k={k} c={c}"
    _assert_close(tag, y, wy, Y_ATOL, Y_RTOL)
    _assert_close(tag + " Σy", s1, w1, SUM_ATOL, SUM_RTOL)
    _assert_close(tag + " Σy²", s2, w2, SUM_ATOL, SUM_RTOL)
    _assert_stored_sums(tag, y, (s1, s2), dim=1)
    _require_same_bits(tag, first, again)
    return tag, (h, w, bias, r), _err(y, wy)


def _device_ms(fn, iters: int = 20) -> float:
    """Device ms a call of fn, on the card's own clock: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host queues ``iters``
    calls between two events, so the events time the calls' kernels back to
    back, without the host gaps that CUDA events around a loop of short
    calls also time. Where the spin ended before the host had queued every
    call, the spin is made longer and the run repeated. (The profiler's
    device records are not used here: on the H100 machine a process loses
    whole profiles of them once it has run for some tens of seconds.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 23
    for _ in range(6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError(f"{iters} calls could not be queued ahead of the card")


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
                out[bn] = _device_ms(lambda: pr.proj_residual_stats(*args))
    finally:
        pr.TILE_WIDTHS = widths
    return out


def check_proj_residual(gen) -> dict:
    """Kernel 4 at its five sites, each called twice, timed by CUDA events
    and by its device time (``site_device_ms``, ``_device_ms``) beside its bf16
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
            device.append(_device_ms(lambda: pr.proj_residual_stats(*args)))
        plain = cuda_ms(lambda: pr.proj_residual_reference(*args), warmup=1, iters=3)
        with torch.no_grad():
            comp = cuda_ms(lambda: _proj_composite(*args))
        composite_ms += comp
        flop = 2 * n * s * k * c
        nbytes = n * s * (k + 2 * c) * 2 + k * c * 2 + 2 * n * c * 4
        forward += count * ms
        forward_bound += count * max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        forward_comp += count * comp
        log(f"    device time {device[-1]:.3f} ms; bf16 composite (Linear + bias, + residual, two "
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
    forward_device = sum(d * site[-1] for d, site in zip(device, PROJ_SITES))
    tally.row.update(composite_ms=composite_ms, forward_ms=forward, forward_bound_ms=forward_bound,
                     forward_composite_ms=forward_comp, site_device_ms=device,
                     forward_device_ms=forward_device)
    log(f"  kernel 4 a CFG forward (33 launches by the sites' counts): {forward:.3f} ms against "
        f"a bound of {forward_bound:.3f} ms ({forward_bound / forward:.0%}); device time "
        f"{forward_device:.3f} ms; bf16 composite {forward_comp:.3f} ms")
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
    attach_mode(tally.row, "heads", check_temporal_block_heads(gen), "temporal_block.heads")
    return tally.row


def check_temporal_block_heads(gen) -> Tally:
    """Kernel 5 on rank 0's heads of a tensor-2 split in its partial mode
    (``parallel/tensor.py``): the q/k/v rows and Wo columns of half the
    heads, the out-projection without bo and x, at the sites whose heads 2
    divides (c = 512, 640, 1280; the 5-head 320 sites stay whole); called
    twice (bit for bit)."""
    from animate_anything_tpu_torch.ops import temporal_block as tb
    from animate_anything_tpu_torch.parallel.tensor import TPGroup, local_slice

    tally = Tally("temporal_block.heads", "animate_anything_tpu_torch/csrc/temporal_block.cu",
                  "animate_anything_tpu/ops/temporal_block.py:408")
    tp = TPGroup(2, 0)
    b, f = 2, FRAMES + 1
    for s, c in TEMPORAL_SITES:
        heads = c // 64
        if heads % 2:
            continue
        x, ln_s, ln_b, wq, wk, wv, wo, _ = _temporal_block_args(gen, b, f, s, c)
        args = (x, ln_s, ln_b, *(local_slice(w, 0, False, tp).contiguous() for w in (wq, wk, wv)),
                local_slice(wo, 1, False, tp).contiguous(), None)
        del wq, wk, wv, wo
        local = heads // 2
        tag = f"temporal_block heads b={b} f={f} s={s} c={c} heads={local} of {heads}"
        got = tb.temporal_block(*args, heads=local, partial=True)
        again = tb.temporal_block(*args, heads=local, partial=True)
        want = tb.temporal_block_reference(*args, heads=local, partial=True)
        _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        ms = cuda_ms(lambda: tb.temporal_block(*args, heads=local, partial=True))
        plain = cuda_ms(lambda: tb.temporal_block_reference(*args, heads=local, partial=True),
                        warmup=1, iters=3)
        rows, inner = b * f * s, c // 2
        flop = 8 * rows * c * inner + 4 * b * s * local * f * f * 64
        nbytes = 2 * rows * c * 2 + 4 * c * inner * 2 + 2 * c * 4
        tally.add(tag, _err(got, want), ms, plain, flop, nbytes)
        del args, got, again, want
        torch.cuda.empty_cache()
    return tally


def check_channel_sums(gen) -> dict:
    """Kernel 6 at every statistics site of the opt-in CFG forward
    (``utils/kernel_sites.CHANNEL_SUMS_SITES``: resnet inputs of 34 frames,
    temporal convs' first stages of 2 samples x 17 frames), each called
    twice (bit for bit: no atomics on the sums) and summed over a forward by
    the sites' counts, by events and by device time (``_device_ms``; the
    events of a call this short time the host that issues it:
    ``forward_ms``, ``forward_device_ms``, ``forward_bound_ms``); and each
    site's call with its rows knocked out (one row a sample), whose device
    time is what a call costs beyond its bytes
    (``forward_one_row_device_ms``)."""
    from animate_anything_tpu_torch.ops import group_norm as gn
    from animate_anything_tpu_torch.utils.kernel_sites import CHANNEL_SUMS_SITES

    tally = Tally("channel_sums", "animate_anything_tpu_torch/csrc/group_norm.cu",
                  "animate_anything_tpu/ops/group_norm.py:102")
    forward = forward_bound = forward_device = forward_fixed = 0.0
    for n, s, c, count in CHANNEL_SUMS_SITES:
        x = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        got = gn.stream_channel_sums(x)
        again = gn.stream_channel_sums(x)
        want = gn.channel_sums(x)
        tag = f"channel_sums n={n} s={s} c={c}"
        # the same fp32 sums in another order
        _assert_close(tag + " Σx", got[0], want[0], STORED_SUM_ATOL, STORED_SUM_RTOL)
        _assert_close(tag + " Σx²", got[1], want[1], STORED_SUM_ATOL, STORED_SUM_RTOL)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"{tag}: two calls differ")
        ms = cuda_ms(lambda: gn.stream_channel_sums(x))
        plain = cuda_ms(lambda: gn.channel_sums(x))
        nbytes = n * s * c * 2 + 2 * n * c * 4
        device = _device_ms(lambda: gn.stream_channel_sums(x))
        # the rows knocked out: one row a sample, what a call costs beyond its bytes
        x1 = x[:, :1].contiguous()
        fixed = _device_ms(lambda: gn.stream_channel_sums(x1))
        forward += count * ms
        forward_device += count * device
        forward_fixed += count * fixed
        forward_bound += count * nbytes / PEAK_HBM_BYTES * 1e3
        log(f"    device time {device:.4f} ms, {fixed:.4f} ms with one row a sample; "
            f"{count} a CFG forward")
        tally.add(tag, max(_err(got[0], want[0]), _err(got[1], want[1])), ms, plain,
                  3 * n * s * c, nbytes)
        del x
    tally.row.update(forward_ms=forward, forward_device_ms=forward_device,
                     forward_bound_ms=forward_bound, forward_one_row_device_ms=forward_fixed)
    log(f"  kernel 6 a CFG forward ({sum(site[3] for site in CHANNEL_SUMS_SITES)} calls by the "
        f"sites' counts): {forward:.3f} ms by events, {forward_device:.3f} ms of device time "
        f"({forward_fixed:.3f} with one row a sample), against a bound of "
        f"{forward_bound:.3f} ms")
    return tally.row


def _calls_a_call(fn, module, iters: int = 4) -> float:
    """Calls of a kernel's C entry a call of fn: the rise of the wrapper's
    ``module.launches`` counter, which it raises once after each call."""
    before = module.launches
    for _ in range(iters):
        fn()
    return (module.launches - before) / iters


def check_streaming_gn(gen) -> dict:
    """Kernel 7 at every GroupNorm site of the VAE's 512 px image encode and
    16-frame decode in the opt-in configuration (``utils/kernel_sites``;
    GroupNorm + SiLU, and the mid-block attention's norm without), each
    called twice (bit for bit: no atomics on the sums) and counted in
    calls of its C entry a call (one launch), timed by events and by
    device time (``_device_ms``) and summed over an encode and a decode by the
    sites' counts; its bound reads x once (the rows a block does not hold
    and reads twice, ``launch_plan``'s ``rows_read_twice``, are logged beside
    it and not counted). F.group_norm as the library time where there is no
    SiLU."""
    from animate_anything_tpu_torch.ops import streaming_group_norm as sg
    from animate_anything_tpu_torch.utils.kernel_sites import (STREAM_GN_DECODE_SITES,
                                                               STREAM_GN_ENCODE_SITES)

    tally = Tally("group_norm_stream", "animate_anything_tpu_torch/csrc/group_norm.cu",
                  "animate_anything_tpu/ops/attic/streaming_group_norm.py:110")
    totals = {}
    for path, sites in (("decode", STREAM_GN_DECODE_SITES), ("encode", STREAM_GN_ENCODE_SITES)):
        # bound_rereads_ms: the bound with the rows the design reads twice (a diagnostic)
        t = dict(ms=0.0, device_ms=0.0, bound_ms=0.0, bound_rereads_ms=0.0, calls=0)
        for n, s, c, silu, count in sites:
            groups = 32
            x = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
            scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
            hw = int(s ** 0.5)
            tag = f"group_norm_stream {path} n={n} s={hw}x{hw} c={c} silu={silu}"
            run = lambda: sg.group_norm_stream(x, scale, bias, groups, 1e-6, silu)  # noqa: E731
            with torch.no_grad():
                got, again = run(), run()
                want = sg.group_norm_stream_reference(x, scale, bias, groups, 1e-6, silu)
                _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
                if not torch.equal(got, again):
                    raise AssertionError(f"{tag}: two calls differ")
                del again
                ms = cuda_ms(run)
                device = _device_ms(run, iters=10)
                # aat_group_norm launches kernel 7 once, whatever the plan
                per_call = _calls_a_call(run, sg)
                if per_call != 1:
                    raise AssertionError(f"{tag}: {per_call} kernel-7 launches a call, not 1")
                plain = cuda_ms(lambda: sg.group_norm_stream_reference(x, scale, bias, groups,
                                                                       1e-6, silu),
                                warmup=1, iters=3)
                library = None
                if not silu:   # one call of the same function (weights in x's dtype)
                    sb, bb = scale.to(x.dtype), bias.to(x.dtype)
                    library = cuda_ms(lambda: F.group_norm(x.transpose(1, 2), groups, sb, bb,
                                                           1e-6))
            plan = sg.launch_plan(n, s, c, groups)
            xbytes = n * s * c * 2
            nbytes = 2 * xbytes + 2 * c * 4
            tally.add(tag, _err(got, want), ms, plain, (8 if silu else 3) * n * s * c, nbytes,
                      library)
            held = "x read once" if plan["read_once"] else (
                f"{1 - plan['rows_read_twice'] / (n * s):.1%} of the rows read once")
            log(f"    device time {device:.4f} ms, 1 launch a call, {count} a {path}; "
                f"{held}; bound {nbytes / PEAK_HBM_BYTES * 1e3:.3f} ms (x read once), "
                f"{(nbytes + plan['rows_read_twice'] * c * 2) / PEAK_HBM_BYTES * 1e3:.3f} ms "
                f"with the rows the design reads twice")
            t["ms"] += count * ms
            t["device_ms"] += count * device
            t["bound_ms"] += count * nbytes / PEAK_HBM_BYTES * 1e3
            t["bound_rereads_ms"] += (count * (nbytes + plan["rows_read_twice"] * c * 2)
                                      / PEAK_HBM_BYTES * 1e3)
            t["calls"] += count
            del x, got, want
            torch.cuda.empty_cache()
        totals[path] = t
        log(f"  kernel 7 a {path} ({t['calls']} calls): {t['ms']:.3f} ms by events, "
            f"{t['device_ms']:.3f} ms of device time, against a bound of {t['bound_ms']:.3f} ms "
            f"({t['bound_rereads_ms']:.3f} ms with the rows the design reads twice)")
    tally.row.update({f"{path}_{k}": v for path, t in totals.items() for k, v in t.items()})
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
    """Kernel 9 at the packed request's five frame-attention sites, summed
    over a CFG forward by the sites' launch counts (``forward_ms``,
    ``forward_bound_ms``, ``forward_library_ms``), at JAX's ragged test
    shapes (locations that do not fill the last pack of ``_packed_forward``;
    below the gate's 512 locations·heads, so through the kernel's wrapper
    directly), and at the edges of its reach at a ragged s: head dims 40,
    128, 160 and 256, 48 and 128 frames; each called twice (bit for bit).
    SDPA over the (b, s, h, f, d) permuted view as the library time."""
    from animate_anything_tpu_torch.ops import temporal_attention as ta

    tally = Tally("temporal_attention", "animate_anything_tpu_torch/csrc/temporal_attention.cu",
                  "animate_anything_tpu/ops/temporal_attention.py:97")
    full = [(2, FRAMES + 1, s, h, 64) for s, h in PACKED_SITES]
    ragged = [(1, 17, 33, 2, 64), (2, 14, 40, 1, 32), (2, 2, 40, 1, 32)]
    # head dims not a multiple of 16 or 64 and up to 256, f > 32 and f = 128
    reach = [(2, 17, 40, 3, 40), (1, 48, 24, 2, 64), (2, 17, 100, 4, 128), (2, 17, 100, 3, 160),
             (1, 17, 70, 2, 256), (1, 128, 30, 2, 64), (1, 128, 9, 2, 256)]
    counts = dict(zip(full, PACKED_SITE_CALLS))
    forward = forward_bound = forward_library = forward_device = 0.0
    for b, f, s, h, d in full + ragged + reach:
        q, k, v = (torch.randn(b, f, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        tag = f"temporal_attention b={b} f={f} s={s} h={h} d={d}"
        plan = ta.launch_plan(b, f, s, h, d)
        log(f"    plan: L={plan['L']} HB={plan['HB']} stages={plan['stages']} "
            f"warps={plan['warps']} grid={plan['grid']} smem={plan['smem']}")
        with torch.no_grad():
            got = ta.packed_temporal_attention(q, k, v)
            again = ta.packed_temporal_attention(q, k, v)
            want = ta.temporal_attention_reference(q, k, v)
            _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two calls differ")
            ms = cuda_ms(lambda: ta.packed_temporal_attention(q, k, v))
            plain = cuda_ms(lambda: ta.temporal_attention_reference(q, k, v), warmup=1, iters=3)
            qp, kp, vp = (x.permute(0, 2, 3, 1, 4) for x in (q, k, v))
            library = cuda_ms(lambda: F.scaled_dot_product_attention(qp, kp, vp))
        flop, nbytes = 4 * b * s * h * f * f * d, 4 * b * f * s * h * d * 2
        count = counts.get((b, f, s, h, d), 0)
        if count:
            with torch.no_grad():
                device = _device_ms(lambda: ta.packed_temporal_attention(q, k, v))
            log(f"    device time {device} ms; {count} a packed CFG forward")
            forward_device += count * device
        forward += count * ms
        forward_bound += count * max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        forward_library += count * library
        tally.add(tag, _err(got, want), ms, plain, flop, nbytes, library)
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
    tally.row.update(forward_ms=forward, forward_device_ms=forward_device,
                     forward_bound_ms=forward_bound, forward_library_ms=forward_library)
    log(f"  kernel 9 a packed CFG forward ({PACKED_PER_FORWARD} launches by the sites' counts): "
        f"{forward:.3f} ms by events, {forward_device:.3f} ms of device time, against a bound "
        f"of {forward_bound:.3f} ms; SDPA on the permuted view {forward_library:.3f} ms")
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
    the three-call composite (add, two reductions) is a reference line. Each
    shape is also timed by device time (``site_device_ms``, ``_device_ms``:
    the events around a loop of short calls time the host that launches
    them)."""
    from animate_anything_tpu_torch.ops import add_stats as ad

    tally = Tally("add_with_stats", "animate_anything_tpu_torch/csrc/group_norm.cu",
                  "animate_anything_tpu/ops/attic/add_stats.py:68")
    cfg = 2 * (FRAMES + 1)
    composite_ms = 0.0
    site_device = []
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
            device = _device_ms(lambda: ad.add_with_stats(x, r, impl="pallas"))
        composite_ms += comp
        site_device.append(device)
        log(f"    device time {device:.4f} ms; three-call composite (add, Σ, Σ²; "
            f"a reference line) {comp:.3f} ms")
        tally.add(tag, _err(y, wy), ms, plain, 3 * n * s * c, 3 * n * s * c * 2 + 2 * n * c * 4)
    tally.row.update(composite_ms=composite_ms, site_device_ms=site_device)
    return tally.row


def check_ln_qkv(gen) -> dict:
    """Kernels 11 and 1 (``ln_qkv_attention``) at the UNet's three spatial
    self-attention sites (norm1 -> to_q/k/v -> attention) and at JAX's test
    shapes, against the plain version on the first and the last two
    samples, each called twice (bit for bit). A call's device time less
    kernel 1's alone at its shape is kernel 11's (its statistics pass and
    GEMM: two launches). No single PyTorch call computes it; the three-call
    composite (``F.layer_norm``, one q|k|v matmul, SDPA) is a reference line,
    and beside kernel 11's own time, its front half (``F.layer_norm`` and the
    q|k|v matmul) and the bound of that half."""
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops import ln_qkv_attention as lq
    from animate_anything_tpu_torch.utils.kernel_sites import LN_QKV_SITES

    tally = Tally("ln_qkv_attention", "animate_anything_tpu_torch/csrc/ln_qkv.cu",
                  "animate_anything_tpu/ops/attic/ln_qkv_attention.py:130")
    tally.row["source_also"] = "animate_anything_tpu_torch/csrc/flash_attention.cu"
    composite_ms = 0.0
    sites = dict(k11_device_ms=[], k1_device_ms=[], front_composite_ms=[], front_bound_ms=[])
    for b, s, c, h in LN_QKV_SITES + ((2, 256, 128, 2), (1, 300, 192, 3)):
        hd = 64 * h
        x = torch.randn(b, s, c, generator=gen, device="cuda").to(torch.bfloat16)
        lns = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        lnb = 0.1 * torch.randn(c, generator=gen, device="cuda")
        ws = [_lecun(gen, c, hd, fan_in=c) for _ in range(3)]
        kw = dict(heads=h, head_dim=64, eps=1e-5)
        tag = f"ln_qkv_attention b={b} s={s} c={c} h={h}"
        run = lambda: lq.ln_qkv_attention(x, lns, lnb, *ws, impl="pallas", **kw)  # noqa: E731
        with torch.no_grad():
            got = run()
            if not torch.equal(got, run()):
                raise AssertionError(f"{tag}: two calls differ")
            err = max(_assert_attention(f"{tag} samples {sl.start}:{sl.stop}", got[sl],
                                        lq.ln_qkv_attention_reference(x[sl], lns, lnb, *ws, **kw))
                      for sl in _first_and_last(b))
            ms = cuda_ms(run)
            # kernel 11's device time: the call's less kernel 1's alone on q, k, v of its shape
            whole = _device_ms(run, iters=5)
            qkv = [torch.randn(b, s, h, 64, device="cuda").to(torch.bfloat16) for _ in range(3)]
            k1 = _device_ms(lambda: fa.flash_forward_with_lse(*qkv, with_lse=False,
                                                              prescaled=True), iters=5)
            k11 = whole - k1
            del qkv
            # aat_ln_qkv launches kernel 11's two passes, the statistics and the GEMM
            per_call = _calls_a_call(run, lq)
            if per_call != 1:
                raise AssertionError(f"{tag}: {per_call} calls of aat_ln_qkv a call, not 1")
            plain = cuda_ms(lambda: [lq.ln_qkv_attention_reference(x[i:i + 2], lns, lnb, *ws, **kw)
                                     for i in range(0, b, 2)], warmup=1, iters=2)
            wqkv = torch.cat(ws, 1)
            lnsb, lnbb = lns.to(x.dtype), lnb.to(x.dtype)
            front = lambda: F.layer_norm(x, (c,), lnsb, lnbb, 1e-5) @ wqkv  # noqa: E731

            def composite():
                q, k, v = (t.reshape(b, s, h, 64) for t in front().split(hd, -1))
                return _sdpa(q, k, v)
            comp = cuda_ms(composite)
            front_ms = cuda_ms(front)
        n = b * s
        front_bound = max(6 * n * c * hd / PEAK_BF16_FLOPS,
                          (n * (c + 3 * hd) * 2 + 3 * c * hd * 2) / PEAK_HBM_BYTES) * 1e3
        composite_ms += comp
        log(f"    device time: kernel 11 {k11:.4f} ms (two launches a call: the statistics "
            f"and the GEMM), kernel 1 {k1:.4f} ms; kernel 11's half: composite "
            f"(layer_norm, q|k|v matmul; a reference line) {front_ms:.3f} ms, bound "
            f"{front_bound:.4f} ms; three-call composite (+ SDPA) {comp:.3f} ms")
        if (b, s, c, h) in LN_QKV_SITES:
            for key, val in zip(sites, (k11, k1, front_ms, front_bound)):
                sites[key].append(val)
        flop = 4 * b * h * s * s * 64 + 6 * b * s * c * hd
        nbytes = b * s * (c + hd) * 2 + 3 * c * hd * 2 + 2 * c * 4
        tally.add(tag, err, ms, plain, flop, nbytes)
        torch.cuda.empty_cache()
    tally.row["composite_ms"] = composite_ms
    tally.row.update(sites)
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


def _add_site(tally, tag, err, ms, plain, flop, nbytes, calls, forward, library=None):
    """One site's numbers into ``tally`` and, times its calls in a CFG
    forward, into ``forward`` (kernel ms and bound ms)."""
    tally.add(tag, err, ms, plain, flop, nbytes, library)
    forward["ms"] += calls * ms
    forward["bound_ms"] += calls * max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


def check_sites(gen, rows: list[dict], label: str, sites: dict) -> None:
    """Kernels at one path's sites (``sites``: ``bf`` = b·f, ``frames``,
    ``eps`` of the temporal GroupNorm, ``residual_share`` of kernel 3's
    calls, and (site, calls) tables ``flash``, ``geglu``, ``tap``,
    ``block`` and optionally ``proj`` from ``utils/kernel_sites``), each
    against its plain version, called twice (every output bit for bit,
    kernels 3 and 4's sums included), timed by CUDA
    events beside its bound; kernel 3 on the GroupNorm fold, with and
    without the residual. Adds to each kernel's row ``{label}_ms``,
    ``{label}_plain_ms``, ``{label}_bound_ms`` (summed over the sites) and
    ``{label}_forward_ms``, ``{label}_forward_bound_ms`` (summed over a CFG
    forward by the sites' counts); ``{label}_library_ms`` for kernel 1
    (SDPA)."""
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops import geglu
    from animate_anything_tpu_torch.ops import proj_residual as pr
    from animate_anything_tpu_torch.ops import temporal_block as tb
    from animate_anything_tpu_torch.ops import temporal_conv as tc
    from animate_anything_tpu_torch.ops.group_norm import group_affine

    bf, frames, eps = sites["bf"], sites["frames"], sites["eps"]
    by_name = {row["name"]: row for row in rows}
    log(f"{label} sites (b·f = {bf}, {frames} frames; kernel vs plain version, bf16 inputs):")

    def finish(name, tally, forward):
        row, t = by_name[name], tally.row
        row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
        row.update({f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                    f"{label}_bound_ms": t["bound_ms"], f"{label}_forward_ms": forward["ms"],
                    f"{label}_forward_bound_ms": forward["bound_ms"]})
        if t["library_ms"] is not None:
            row[f"{label}_library_ms"] = t["library_ms"]
        log(f"  {name}: a CFG forward's {label} sites {forward['ms']:.3f} ms, bound "
            f"{forward['bound_ms']:.3f} ms")

    tally, fwd = Tally("flash_attention", "", ""), {"ms": 0.0, "bound_ms": 0.0}
    for s, h, calls in sites["flash"]:
        q, k, v = (torch.randn(bf, s, h, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        tag = f"flash_attention b={bf} s={s} h={h} d=64 ({label})"
        got, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        err = max(_assert_attention(f"{tag} samples {sl.start}-{sl.stop - 1}", got[sl],
                                    fa.attention_reference(q[sl], k[sl], v[sl]))
                  for sl in _first_and_last(bf))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        plain = cuda_ms(lambda: [fa.attention_reference(q[i:i + 2], k[i:i + 2], v[i:i + 2])
                                 for i in range(0, bf, 2)], warmup=1, iters=2)
        library = cuda_ms(lambda: _sdpa(q, k, v))
        _add_site(tally, tag, err, ms, plain, 4 * bf * h * s * s * 64, 4 * bf * s * h * 64 * 2,
                  calls, fwd, library)
        del q, k, v, got, again
        torch.cuda.empty_cache()
    finish("flash_attention", tally, fwd)

    tally, fwd = Tally("ln_geglu_ff", "", ""), {"ms": 0.0, "bound_ms": 0.0}
    for n, c, calls in sites["geglu"]:
        args = _geglu_args(gen, n, c)
        tag = f"ln_geglu_ff n={n} c={c} ({label})"
        got, again = geglu.ln_geglu_ff(*args), geglu.ln_geglu_ff(*args)
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        want = geglu.ln_geglu_reference(*args, 1e-5)
        _assert_close(tag, got, want, Y_ATOL, Y_RTOL)
        ms = cuda_ms(lambda: geglu.ln_geglu_ff(*args))
        plain = cuda_ms(lambda: geglu.ln_geglu_reference(*args, 1e-5), warmup=1, iters=3)
        nbytes = 2 * n * c * 2 + 12 * c * c * 2 + (8 * c + 3 * c) * 4
        _add_site(tally, tag, _err(got, want), ms, plain, 24 * n * c * c, nbytes, calls, fwd)
        del args, got, again, want
        torch.cuda.empty_cache()
    finish("ln_geglu_ff", tally, fwd)

    tally, fwd = Tally("tap_conv", "", ""), {"ms": 0.0, "bound_ms": 0.0}
    bsz, f, share = bf // frames, frames, sites["residual_share"]
    for s, c, calls in sites["tap"]:
        x, _, _, w, bias, res = _tap_conv_args(gen, bsz, f, s, c, c)
        gn_s = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        gn_b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        a, b = group_affine(x.reshape(bsz, f * s, c), gn_s, gn_b, 32, eps)
        tag = f"tap_conv bsz={bsz} f={f} s={s} c={c} eps={eps:g} ({label})"
        err = max(_tap_conv_case(f"{tag} residual={r is not None}", x, a, b, w, bias, r)
                  for r in (None, res))
        # a CFG forward runs ``share`` of its calls with the residual
        ms = ((1 - share) * cuda_ms(lambda: tc.tap_conv(x, a, b, w, bias, None))
              + share * cuda_ms(lambda: tc.tap_conv(x, a, b, w, bias, res)))
        plain = cuda_ms(lambda: tc.tap_conv_reference(x, a, b, w, bias, res), warmup=1, iters=3)
        rows_ = bsz * f * s
        nbytes = (2 + share) * rows_ * c * 2 + 3 * c * c * 2 + 2 * bsz * f * c * 4
        _add_site(tally, tag, err, ms, plain, 2 * bsz * s * (3 * f - 2) * c * c, nbytes, calls,
                  fwd)
        del x, res
        torch.cuda.empty_cache()
    finish("tap_conv", tally, fwd)

    tally, fwd = Tally("temporal_block", "", ""), {"ms": 0.0, "bound_ms": 0.0}
    for s, c, heads, calls in sites["block"]:
        args = _temporal_block_args(gen, bsz, f, s, c)
        tag = f"temporal_block b={bsz} f={f} s={s} c={c} heads={heads} ({label})"
        err = _temporal_block_case(tag, args, heads)
        ms = cuda_ms(lambda: tb.temporal_block(*args, heads=heads))
        plain = cuda_ms(lambda: tb.temporal_block_reference(*args, heads=heads), warmup=1,
                        iters=3)
        rows_ = bsz * f * s
        flop = 8 * rows_ * c * c + 4 * bsz * s * heads * f * f * (c // heads)
        nbytes = 2 * rows_ * c * 2 + 4 * c * c * 2 + 3 * c * 4
        _add_site(tally, tag, err, ms, plain, flop, nbytes, calls, fwd)
        del args
        torch.cuda.empty_cache()
    finish("temporal_block", tally, fwd)

    if "proj" not in sites:
        return
    tally, fwd = Tally("proj_residual_stats", "", ""), {"ms": 0.0, "bound_ms": 0.0}
    for s, k, c, calls in sites["proj"]:
        tag, args, err = _proj_case(gen, bf, s, k, c)
        ms = cuda_ms(lambda: pr.proj_residual_stats(*args))
        plain = cuda_ms(lambda: pr.proj_residual_reference(*args), warmup=1, iters=3)
        flop = 2 * bf * s * k * c
        nbytes = bf * s * (k + 2 * c) * 2 + k * c * 2 + 2 * bf * c * 4
        _add_site(tally, f"{tag} ({label})", err, ms, plain, flop, nbytes, calls, fwd)
        del args
        torch.cuda.empty_cache()
    finish("proj_residual_stats", tally, fwd)


def svd_sites() -> dict:
    """The SVD UNet's sites: b·f = 28, 14 frames, kernel 3 at eps 1e-6, half
    its calls with the residual; kernels 1, 2, 3, 5."""
    from animate_anything_tpu_torch.utils import kernel_sites as ks

    return dict(bf=ks.SVD_BF, frames=ks.SVD_FRAMES, eps=1e-6, residual_share=0.5,
                flash=ks.SVD_FLASH_SITES, geglu=ks.SVD_GEGLU_SITES, tap=ks.SVD_TAP_SITES,
                block=ks.SVD_BLOCK_SITES)


def stage2_sites() -> dict:
    """The stage-2 request's sites (384 px: 48×48 latents, s = 2304 / 576 /
    144 / 36): b·f = 18, 9 frames, kernel 3 at eps 1e-5 (the UNet3D's
    temporal convs), a quarter of its calls with the residual; kernels 1-5."""
    from animate_anything_tpu_torch.utils import kernel_sites as ks

    return dict(bf=ks.STAGE2_BF, frames=ks.STAGE2_FRAMES, eps=1e-5, residual_share=0.25,
                flash=ks.STAGE2_FLASH_SITES, geglu=ks.STAGE2_GEGLU_SITES,
                tap=ks.STAGE2_TAP_SITES, block=ks.STAGE2_BLOCK_SITES,
                proj=ks.STAGE2_PROJ_SITES)


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
            "ln_qkv_attention": (ln_qkv_attention, "launches"),
            # the modes of the frame and tensor axes, counted within their kernel's count
            "tap_conv.positions": (temporal_conv, "frame_launches"),
            "ln_geglu_ff.partial": (geglu, "partial_launches"),
            "temporal_block.heads": (temporal_block, "partial_launches")}


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

    ref, gen = _small_unet(seed, attn_impl="pallas", gradient_checkpointing=True)
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
                                                 attn_impl="pallas",
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


def cfg_forward_inputs(seed: int) -> tuple:
    """A full-width CFG forward's inputs (2 x 16 frames, 64x64 latents, the
    mask UNet's condition frame, mask and motion strength, t = 500)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, FRAMES, 64, 64, 4, generator=gen, device="cuda")
    cond = torch.randn(2, 1, 64, 64, 4, generator=gen, device="cuda")
    mask = (torch.rand(2, 1, 64, 64, 1, generator=gen, device="cuda") > 0.5).float()
    emb = torch.randn(2, 77, 1024, generator=gen, device="cuda")
    motion = torch.tensor([5.0, 5.0], device="cuda")
    return x, 500, emb, cond, mask, motion


def compare_packed_xla(packed_unet, seed: int = 3) -> float:
    """One full-width CFG forward (2 x 16 frames, 64x64 latents) of the same
    weights under "packed" and under "xla": they differ only in the
    frame-attention core. The "xla" forward launches no kernel."""
    xla_unet = packed_unet.with_attn_impl("xla")
    inputs = cfg_forward_inputs(seed)
    with torch.no_grad():
        packed = packed_unet(*inputs).float()
        torch.cuda.synchronize()
        reset_counts()
        xla = xla_unet(*inputs).float()
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

EVAL_CONFIG_PATH = "configs/train_mask_motion.yaml"
# Two identical in-memory eval requests (same weights, seeds and inputs)
# differed by 0.094 and 0.109 over [-1, 1] frames on an H100 80GB HBM3 at
# 700 W while kernels 3 and 4 added their sums with atomics; now they must be
# bit-equal. The two in-memory runs, and the run from the saved directory
# against the first, must stay within this.
EVAL_RUN_TO_RUN = 0.25
EVAL_DDIM_STEPS = 4
# The 4-step DDIM video must differ from the 25-step DPM-Solver++ one by more
# than this (max |diff| over [-1, 1] frames): another sampler and grid, not
# a rounding of the same result.
DDIM_MIN_DIFF = 0.1


@contextlib.contextmanager
def _captured_requests(keep_models: bool = False):
    """Record each ``LatentToVideoPipeline.animate_image`` call's (video,
    latents) on the host and its seconds, and each model build's
    (``cli.eval_models``) seconds under ``"build"`` (the models themselves
    under ``"models"`` when ``keep_models``), each ended by a device sync."""
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    seen = {"requests": [], "build": []}
    orig, orig_build = LatentToVideoPipeline.animate_image, cli.eval_models

    def recorded(self, *args, **kw):
        t0 = time.perf_counter()
        video, latents = orig(self, *args, **kw)
        torch.cuda.synchronize()
        seen["requests"].append((video.float().cpu(), latents.float().cpu(),
                                 time.perf_counter() - t0))
        return video, latents

    def timed_build(*args, **kw):
        t0 = time.perf_counter()
        models = orig_build(*args, **kw)
        torch.cuda.synchronize()
        seen["build"].append(time.perf_counter() - t0)
        if keep_models:
            seen["models"] = models
        return models

    LatentToVideoPipeline.animate_image, cli.eval_models = recorded, timed_build
    try:
        yield seen
    finally:
        LatentToVideoPipeline.animate_image, cli.eval_models = orig, orig_build


def _rel_rms(got, want) -> float:
    return float((got.float() - want.float()).square().mean().sqrt()
                 / want.float().square().mean().sqrt())


def _check_sample(tag: str, metrics: dict, video) -> None:
    import os

    if tuple(video.shape) != (1, FRAMES, RES, RES, 3):
        raise AssertionError(f"{tag}: video shape {tuple(video.shape)}")
    if not torch.isfinite(video).all():
        raise AssertionError(f"{tag}: non-finite video")
    missing = [k for k in ("motion_precision", "latent_motion_score") if k not in metrics]
    if missing:
        raise AssertionError(f"{tag}: metrics {missing} missing from {metrics}")
    if not os.path.isfile(metrics["sample_path"]):
        raise AssertionError(f"{tag}: sample {metrics['sample_path']} not written")


def _eval_run(tag: str, cfg: dict, models_out: Optional[list] = None) -> tuple:
    """``main_eval(**cfg)`` once on the card: → (video, launches); the models
    it ran appended to ``models_out`` when given."""
    from animate_anything_tpu_torch.cli import main_eval

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _captured_requests(keep_models=models_out is not None) as seen:
        t0 = time.perf_counter()
        metrics = main_eval(**cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    (video, _, request), = seen["requests"]
    build, = seen["build"]
    if models_out is not None:
        models_out.append(seen["models"])
    _check_sample(tag, metrics, video)
    log(f"  {tag}: main_eval {dt:.3f} s (the model build {build:.3f} s, the request "
        f"{request:.3f} s, the sample's writes and metrics {dt - build - request:.3f} s), "
        f"peak device memory {peak:.2f} GiB; motion_precision "
        f"{metrics['motion_precision']:.4f}, latent_motion_score "
        f"{metrics['latent_motion_score']:.4f}, sample {metrics['sample_path']}")
    require_only(tag, launches, FORWARD_KERNELS)
    return video, launches


# Each default-path kernel's launcher (module under ops/, function): the
# function that launches the kernel and allocates every output it writes.
LAUNCHERS = {"flash_attention": ("flash_attention", "flash_forward_with_lse"),
             "ln_geglu_ff": ("geglu", "_launch"), "tap_conv": ("temporal_conv", "_launch"),
             "proj_residual_stats": ("proj_residual", "_launch"),
             "temporal_block": ("temporal_block", "_launch")}


def _flat_tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat_tensors(o)]
    return []


@contextlib.contextmanager
def _launched_twice():
    """Every default-path kernel launched twice a call on the same inputs,
    the first result kept. Yields {kernel: {"calls", "differ", "max_abs",
    "max_rel"}}: the calls whose two results were not bit-equal, and for
    each output (y, then the sums where a kernel stores them) the largest
    |difference| and that over the output's largest |value|."""
    import importlib

    seen = {}
    saved = []
    for name, (mod_name, fn_name) in LAUNCHERS.items():
        mod = importlib.import_module(f"animate_anything_tpu_torch.ops.{mod_name}")
        orig = getattr(mod, fn_name)
        rec = seen[name] = {"calls": 0, "differ": 0, "max_abs": [], "max_rel": []}

        def twice(*args, _orig=orig, _rec=rec, **kw):
            first = _orig(*args, **kw)
            second = _orig(*args, **kw)
            a, b = _flat_tensors(first), _flat_tensors(second)
            if len(_rec["max_abs"]) < len(a):
                _rec["max_abs"] += [0.0] * (len(a) - len(_rec["max_abs"]))
                _rec["max_rel"] += [0.0] * (len(a) - len(_rec["max_rel"]))
            _rec["calls"] += 1
            _rec["differ"] += int(not all(torch.equal(x, y) for x, y in zip(a, b)))
            for i, (x, y) in enumerate(zip(a, b)):
                d = _err(x, y)
                _rec["max_abs"][i] = max(_rec["max_abs"][i], d)
                _rec["max_rel"][i] = max(_rec["max_rel"][i],
                                         d / max(float(y.float().abs().max()), 1e-30))
            return first

        saved.append((mod, fn_name, orig))
        setattr(mod, fn_name, twice)
    try:
        yield seen
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)


def repeat_cfg_forward(unet, vae, seed: int = 11) -> dict:
    """Identical calls give identical bits: one CFG forward of ``unet``
    twice on the same inputs, one 16-frame VAE decode twice, then the
    forward once with every kernel launched twice a call
    (``_launched_twice``), each pair bit-equal. Returns the per-kernel
    record."""
    from animate_anything_tpu_torch.models.vae import decode_video

    inputs = cfg_forward_inputs(seed)
    z = torch.randn(1, FRAMES, 64, 64, 4, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        a, b = (unet(*inputs).float() for _ in range(2))
        da, db = (decode_video(vae, z).float() for _ in range(2))
        with _launched_twice() as seen:
            unet(*inputs)
        torch.cuda.synchronize()
    idle = [name for name, rec in seen.items() if rec["calls"] == 0]
    if idle:
        raise AssertionError(f"repeat_cfg_forward: no call reached the launchers of {idle}")
    log(f"  one CFG forward twice on the same inputs: max |diff| {_err(a, b):.4g}, relative "
        f"RMS {_rel_rms(a, b):.3g}; one 16-frame VAE decode twice: max |diff| "
        f"{_err(da, db):.4g}")
    for name, rec in seen.items():
        log(f"  {name}: {rec['differ']} of {rec['calls']} calls gave another result on the "
            f"same inputs; max |diff| by output {[f'{v:.3g}' for v in rec['max_abs']]}, over "
            f"the output's max |value| {[f'{v:.3g}' for v in rec['max_rel']]}")
    differ = {name: rec["differ"] for name, rec in seen.items() if rec["differ"]}
    if differ or not torch.equal(a, b) or not torch.equal(da, db):
        raise AssertionError(f"repeat_cfg_forward: identical calls differ (kernels {differ}, "
                             f"forward {_err(a, b):.4g}, decode {_err(da, db):.4g})")
    return seen


def run_eval_entry() -> dict:
    """The ``train.py --eval`` entry point of the port at
    ``configs/train_mask_motion.yaml`` (full width, bf16, attn_impl pallas,
    512 px, 16 frames, 25 DPM-Solver++ steps, CFG 9; random weights, since
    its checkpoint directory is not in the repository):

    (a) ``main_eval`` twice in memory: the video finite and of its shape,
        the sample written, both metrics reported, kernels 1-5 launched and
        no other; the two videos within ``EVAL_RUN_TO_RUN``;
    (b) the same weights (``cli.eval_models``) written by ``save_pipeline``
        (fp32) and read back bit for bit; the models ``eval_models`` builds
        from that directory equal to the in-memory ones bit for bit; then
        ``main_eval`` on that directory, its video within
        ``EVAL_RUN_TO_RUN`` of (a)'s;
    (c) one 4-step DDIM request on those weights: finite, kernels 1-5, and
        unlike (a)'s DPM-Solver++ video;
    (d) ``repeat_cfg_forward`` on those weights.

    Returns each kernel's launch count during (a)'s first run."""
    import os
    import shutil
    import tempfile

    from animate_anything_tpu_torch.cli import eval_models, run_validation
    from animate_anything_tpu_torch.core.config import Config, load_config
    from animate_anything_tpu_torch.train.checkpoint import (load_pipeline_components,
                                                             save_pipeline)

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="eval_entry_", dir="build")
    try:
        cfg = dict(load_config(EVAL_CONFIG_PATH).to_dict(), output_dir=os.path.join(work, "out"))
        log(f"eval entry point: main_eval({EVAL_CONFIG_PATH}) with random weights "
            f"({RES}x{RES}, {FRAMES} frames, {STEPS} DPM-Solver++ steps, CFG {GUIDANCE})")
        video, launches = _eval_run("main_eval (a)", cfg)
        video2, _ = _eval_run("main_eval (a), again", cfg)
        spread = _err(video2, video)
        log(f"  run to run: max |diff| {spread:.4g} (limit {EVAL_RUN_TO_RUN}), relative RMS "
            f"{_rel_rms(video2, video):.3g} between the two in-memory runs")
        if spread > EVAL_RUN_TO_RUN:
            raise AssertionError(f"main_eval: two in-memory runs {spread:.4g} apart, above "
                                 f"{EVAL_RUN_TO_RUN}")
        if not torch.equal(video2, video):
            raise AssertionError("main_eval: two identical in-memory runs are not bit-equal")
        log("  the two in-memory runs are bit-equal")
        del video2

        ckpt = os.path.join(work, "pipeline")
        models = eval_models(Config(cfg), "cuda")
        need = 4 * sum(p.numel() for name in ("unet", "vae", "text")
                       for p in models[name].parameters())
        free = shutil.disk_usage(work).free
        if free < 2 * need:
            raise AssertionError(f"save_pipeline: {free / 1e9:.1f} GB free under {work}, "
                                 f"{need / 1e9:.1f} GB to write")
        t0 = time.perf_counter()
        nbytes = save_pipeline(ckpt, models["unet"], models["unet_config"], models["vae"],
                               models["vae_config"], models["text"], models["text_config"])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        comp = load_pipeline_components(ckpt)
        for name in ("unet", "vae", "text_encoder"):
            comp[name] = {k: v.clone() for k, v in comp[name].items()}
        read_s = time.perf_counter() - t0
        log(f"  save_pipeline: {nbytes / 1e9:.3f} GB of fp32 weights written in {write_s:.3f} s "
            f"({free / 1e9:.1f} GB free before), read back in {read_s:.3f} s "
            f"(load_pipeline_components, its memory-mapped tensors copied out; the files just "
            f"written)")
        for name, module in (("unet", models["unet"]), ("vae", models["vae"]),
                             ("text_encoder", models["text"])):
            want = module.state_dict()
            got = comp.pop(name)
            if set(got) != set(want) or not all(
                    torch.equal(got[k], want[k].float().cpu()) for k in want):
                raise AssertionError(f"save_pipeline: {name} weights differ after the round "
                                     f"trip")
        del comp
        loaded = eval_models(Config(dict(cfg, pretrained_model_path=ckpt)), "cuda")
        for name in ("unet", "vae", "text"):
            want, got = models[name].state_dict(), loaded[name].state_dict()
            if set(got) != set(want) or not all(
                    got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"build_models from the saved directory: {name} differs "
                                     f"from the in-memory model")
        del loaded
        log("  the models built from the saved directory equal the in-memory ones bit for bit "
            "(every parameter and buffer, dtypes included)")

        vd = Config(cfg)["validation_data"]
        vd["num_inference_steps"] = EVAL_DDIM_STEPS
        torch.cuda.synchronize()
        reset_counts()
        with _captured_requests() as seen:
            metrics = run_validation(models, vd, os.path.join(work, "ddim"), 0, True, True,
                                     generator=torch.Generator("cuda").manual_seed(0),
                                     sampler="ddim")
        ddim_launches = read_counts()
        (ddim, _, ddim_s), = seen["requests"]
        _check_sample("DDIM request", metrics, ddim)
        require_only("DDIM request", ddim_launches, FORWARD_KERNELS)
        apart = _err(ddim, video)
        log(f"  DDIM request ({EVAL_DDIM_STEPS} steps): {ddim_s:.3f} s, max |diff| {apart:.4g} "
            f"from the DPM-Solver++ video (at least {DDIM_MIN_DIFF}); launches {ddim_launches}")
        if apart <= DDIM_MIN_DIFF:
            raise AssertionError(f"DDIM request: video within {apart:.4g} of DPM-Solver++'s")
        repeat_cfg_forward(models["unet"], models["vae"])
        del models

        loaded, _ = _eval_run("main_eval from the saved directory",
                              dict(cfg, pretrained_model_path=ckpt))
        diff = _err(loaded, video)
        log(f"  from the directory against (a): max |diff| {diff:.4g} (limit "
            f"{EVAL_RUN_TO_RUN}), relative RMS {_rel_rms(loaded, video):.3g}")
        if diff > EVAL_RUN_TO_RUN:
            raise AssertionError(f"main_eval from the saved directory: max |diff| {diff:.4g} "
                                 f"from the in-memory run, above {EVAL_RUN_TO_RUN}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  kernel launches during main_eval (a): {launches}")
    return launches


SVD_KERNELS = ("flash_attention", "ln_geglu_ff", "tap_conv", "temporal_block")
SVD_CONFIG_PATH = "configs/train_svd_mask.yaml"
# One full-width SVD CFG forward under "pallas" against "xla" on the same
# weights and inputs: they differ in the feed-forwards' GELU (tanh in kernel
# 2, exact erf in the composite) and in where bf16 rounds (the kernels' fp32
# epilogues against the composite's bf16 steps), carried through ~150
# layers; held as a relative RMS, as the packed forward against "xla".
SVD_PALLAS_VS_XLA_REL_RMS = 5e-2


def _svd_counts_per_request(steps: int) -> dict:
    """Each SVD kernel's launches in a request of ``steps`` CFG forwards."""
    from animate_anything_tpu_torch.utils.kernel_sites import (SVD_BLOCK_SITES,
                                                               SVD_FLASH_SITES,
                                                               SVD_GEGLU_SITES, SVD_TAP_SITES)

    per = {"flash_attention": sum(k for *_, k in SVD_FLASH_SITES),
           "ln_geglu_ff": sum(k for *_, k in SVD_GEGLU_SITES),
           "tap_conv": sum(k for *_, k in SVD_TAP_SITES),
           "temporal_block": sum(k for *_, k in SVD_BLOCK_SITES)}
    return {name: steps * k for name, k in per.items()}


def require_svd_counts(path: str, counts: dict, steps: int) -> None:
    """``path`` launched kernels 1, 2, 3 and 5 exactly ``steps`` CFG
    forwards' worth (15, 48, 44 and 16 a forward) and no other."""
    require_only(path, counts, SVD_KERNELS)
    want = _svd_counts_per_request(steps)
    got = {name: counts[name] for name in SVD_KERNELS}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def check_small_svd_unet(seed: int = 0) -> float:
    """A small SVD UNet (head dim 32, 16×16 latents so the spatial
    self-attention runs flash at s = 256, 14 frames, 9 channels, CFG's two
    contexts) in bf16 on the card through kernels 1, 2, 3 and 5, held
    against the same weights in fp32 on the CPU through the plain versions
    (``SMALL_REL_RMS``)."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import init_svd_unet_

    cfg = SVDUNetConfig.tiny(in_channels=9, num_attention_heads=(1, 2, 2, 2), attn_impl="pallas")
    ref = UNetSpatioTemporalConditionModel(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_svd_unet_(ref, gen)
    ref.eval()
    b, f, hw = 2, 14, 16
    sample = torch.randn(b, f, hw, hw, 9, generator=gen)
    ctx = torch.randn(b, 1, cfg.cross_attention_dim, generator=gen)
    ctx[0] = 0.0
    ids = torch.tensor([[6.0, 127.0, 0.02]] * b)
    t = torch.tensor(0.25 * 2.3)
    with torch.no_grad():
        want = ref(sample, t, ctx, ids)
        gpu = cast_module_(ref.to("cuda"))
        reset_counts()
        got = gpu(sample.cuda(), t.cuda(), ctx.cuda(), ids.cuda()).float().cpu()
        torch.cuda.synchronize()
    launches = read_counts()
    path = "small SVD UNet forward (attn_impl='pallas', 14 frames)"
    require_only(path, launches, SVD_KERNELS)
    if not torch.isfinite(got).all():
        raise AssertionError("small SVD UNet: non-finite output on the card")
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    log(f"{path}, card (kernels, bf16) vs CPU (plain, fp32): relative RMS {rel:.4g} (limit "
        f"{SMALL_REL_RMS}); launches {launches}")
    if rel > SMALL_REL_RMS:
        raise AssertionError(f"small SVD UNet disagrees with its CPU reference: {rel:.4g}")
    return rel


@contextlib.contextmanager
def _captured_svd():
    """Record each SVD pipeline call's (video, latents) on the host and its
    seconds, and each ``cli_svd.build_svd_models`` call's seconds and
    models, each ended by a device sync."""
    from animate_anything_tpu_torch import cli_svd
    from animate_anything_tpu_torch.pipelines.svd import MaskStableVideoDiffusionPipeline

    seen = {"requests": [], "build": [], "models": []}
    orig, orig_build = MaskStableVideoDiffusionPipeline.__call__, cli_svd.build_svd_models

    def recorded(self, *args, **kw):
        t0 = time.perf_counter()
        video, latents = orig(self, *args, **kw)
        torch.cuda.synchronize()
        seen["requests"].append((video.float().cpu(), latents.float().cpu(),
                                 time.perf_counter() - t0))
        return video, latents

    def timed_build(*args, **kw):
        t0 = time.perf_counter()
        models = orig_build(*args, **kw)
        torch.cuda.synchronize()
        seen["build"].append(time.perf_counter() - t0)
        seen["models"].append(models)
        return models

    MaskStableVideoDiffusionPipeline.__call__, cli_svd.build_svd_models = recorded, timed_build
    try:
        yield seen
    finally:
        MaskStableVideoDiffusionPipeline.__call__, cli_svd.build_svd_models = orig, orig_build


def _svd_run(tag: str, cfg: dict, frames: int, res: int, steps: int,
             keep_models: bool = False) -> tuple:
    """``cli_svd.main_eval(**cfg)`` once on the card → (video, launches,
    the models it built when ``keep_models``, else None)."""
    import os

    from animate_anything_tpu_torch.cli_svd import main_eval

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _captured_svd() as seen:
        t0 = time.perf_counter()
        out = main_eval(**cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    (video, latents, request), = seen["requests"]
    build, = seen["build"]
    if tuple(video.shape) != (1, frames, res, res, 3):
        raise AssertionError(f"{tag}: video shape {tuple(video.shape)}")
    if not torch.isfinite(video).all() or not torch.isfinite(latents).all():
        raise AssertionError(f"{tag}: non-finite output")
    if not os.path.isfile(out["sample_path"]):
        raise AssertionError(f"{tag}: sample {out['sample_path']} not written")
    log(f"  {tag}: main_eval {dt:.3f} s (the model build {build:.3f} s, the request "
        f"{request:.3f} s, the gif's write {dt - build - request:.3f} s), peak device memory "
        f"{peak:.2f} GiB; latents range [{float(latents.min()):.3f}, "
        f"{float(latents.max()):.3f}], sample {out['sample_path']}")
    require_svd_counts(tag, launches, steps)
    return video, launches, seen["models"][0] if keep_models else None


def run_svd_entry() -> dict:
    """The SVD serving path of the port at ``configs/train_svd_mask.yaml``
    (full width, bf16, attn_impl pallas, 9 channels, 512 px, 14 frames, 25
    Euler steps, decode chunk 7; random weights from the seed, as JAX's
    ``build_svd_models`` draws them):

    (a) ``cli_svd.main_eval`` twice: the video finite and of its shape, the
        gif written, kernels 1, 2, 3 and 5 launched 375, 1200, 1100 and 400
        times each run and no other; the two videos within ``EVAL_RUN_TO_RUN``;
    (b) one v2v request on (a)'s weights: ``TextStableVideoDiffusionPipeline``
        on a synthetic 14-frame video's condition latents, the same counts;
    (c) one full-width CFG forward of those weights under "pallas" against
        "xla" (which launches no kernel), within ``SVD_PALLAS_VS_XLA_REL_RMS``.

    Returns each kernel's launch count during (a)'s first run."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from animate_anything_tpu_torch.core.config import load_config
    from animate_anything_tpu_torch.pipelines.svd import TextStableVideoDiffusionPipeline

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="svd_entry_", dir="build")
    try:
        cfg = dict(load_config(SVD_CONFIG_PATH).to_dict(), output_dir=os.path.join(work, "out"))
        vd = cfg["validation_data"]
        frames, res, steps = int(vd["num_frames"]), int(vd["width"]), int(vd["num_inference_steps"])
        log(f"SVD entry point: cli_svd.main_eval({SVD_CONFIG_PATH}) with random weights "
            f"({res}x{res}, {frames} frames, {steps} Euler steps, decode chunk "
            f"{vd['decode_chunk_size']}, attn_impl {cfg['attn_impl']})")
        video, launches, _ = _svd_run("main_eval (a)", cfg, frames, res, steps)
        video2, _, models = _svd_run("main_eval (a), again", cfg, frames, res, steps,
                                     keep_models=True)
        # no value of the SVD path reads kernel 3's Σy, Σy² (they go unused
        # there), so the two are expected equal; held to the eval entry
        # point's bound all the same
        spread = _err(video2, video)
        log(f"  run to run: max |diff| {spread:.4g} (limit {EVAL_RUN_TO_RUN}), relative RMS "
            f"{_rel_rms(video2, video):.3g}")
        if spread > EVAL_RUN_TO_RUN:
            raise AssertionError(f"SVD main_eval: two runs {spread:.4g} apart")
        del video, video2

        pipe = TextStableVideoDiffusionPipeline(models["unet"], models["vae"],
                                                image_encoder=models["image_encoder"])
        rng = np.random.default_rng(3)
        base = rng.integers(0, 256, (res, res, 3)).astype(np.int16)
        clip = np.stack([np.roll(base, 6 * i, axis=1) for i in range(frames)]).astype(np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        cond = pipe.video_to_condition_latent(clip)
        video, latents = pipe(clip[0], condition_latent=cond,
                              mask=torch.ones(1, 1, res // 8, res // 8, 1, device="cuda"),
                              num_frames=frames, num_inference_steps=steps,
                              decode_chunk_size=int(vd["decode_chunk_size"]),
                              generator=torch.Generator("cuda").manual_seed(1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        v2v = read_counts()
        if tuple(video.shape) != (1, frames, res, res, 3) or not torch.isfinite(video).all():
            raise AssertionError(f"v2v request: video {tuple(video.shape)}, finite "
                                 f"{bool(torch.isfinite(video).all())}")
        log(f"  v2v request ({frames}-frame video's condition latents {tuple(cond.shape)}): "
            f"{dt:.3f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require_svd_counts("v2v request", v2v, steps)
        del pipe, video, latents, cond

        # a CFG forward's inputs: 2 × 14 frames at 64×64 latents, a zero and
        # a random image embedding, the continuous timestep of σ = 10
        unet = models["unet"]
        xla = unet.with_attn_impl("xla")
        gen = torch.Generator(device="cuda").manual_seed(5)
        emb = torch.randn(2, 1, unet.config.cross_attention_dim, generator=gen, device="cuda")
        emb[0] = 0.0
        inputs = (torch.randn(2, frames, res // 8, res // 8, unet.config.in_channels,
                              generator=gen, device="cuda"),
                  torch.tensor(0.25 * 2.302585, device="cuda"), emb,
                  torch.tensor([[6.0, 127.0, 0.02]] * 2, device="cuda"))
        with torch.no_grad():
            pallas_out = unet(*inputs).float()
            torch.cuda.synchronize()
            reset_counts()
            xla_out = xla(*inputs).float()
            torch.cuda.synchronize()
        counts = read_counts()
        require_not_launched("SVD xla forward", counts, list(counts))
        if not torch.isfinite(pallas_out).all() or not torch.isfinite(xla_out).all():
            raise AssertionError("SVD pallas vs xla forward: non-finite output")
        rel = _rel_rms(pallas_out, xla_out)
        log(f"  one full-width CFG forward, attn_impl='pallas' vs 'xla' (same weights and "
            f"inputs): relative RMS {rel:.4g} (limit {SVD_PALLAS_VS_XLA_REL_RMS}), max |diff| "
            f"{_err(pallas_out, xla_out):.4g}")
        if rel > SVD_PALLAS_VS_XLA_REL_RMS:
            raise AssertionError(f"SVD pallas forward disagrees with the xla forward: {rel:.4g}")
        del unet, xla, models, pallas_out, xla_out
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  kernel launches during main_eval (a): {launches}")
    return launches


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


TRAIN_LORA_CONFIG_PATH = "configs/train_mask_motion_lora.yaml"
TRAIN_FULL_CONFIG_PATH = "configs/train_mask_motion.yaml"
# The LoRA YAML names no attn_impl, so JAX's default "xla" would run the
# composite modules and no kernel; the phase passes attn_impl=pallas, which
# the full finetune's YAML names itself, so both paths run kernels 1-5.
TRAIN_ATTN_IMPL = "pallas"
# Synthetic clips: the full finetune's batch of 8 needs 8 (the loader drops
# a short last batch).
TRAIN_CLIPS = 8
LORA_STEPS, LORA_CKPT_STEPS, LORA_RESUME_STEPS = 6, 3, 8
FULL_STEPS = 2
# The full finetune's YAML asks for batch 8; on the 80 GB H100 that batch
# runs out of memory in the step's VAE encode (all 128 frames at once, as in
# JAX: "Tried to allocate 16.00 GiB ... 59.94 GiB is allocated by PyTorch"),
# and batch 4 fits (48.1 GiB peak). Measured on the card; the phase sets it.
FULL_BATCH = 4
TRAIN_ENTRY_KERNELS = FORWARD_KERNELS + ("flash_attention_bwd",)


def lora_entry_argv(json_path: str) -> list[str]:
    """The LoRA runs' command line: the YAML, its dataset's JSON and the
    kernels' ``attn_impl`` (the runs add their step counts and directories)."""
    return ["--config", TRAIN_LORA_CONFIG_PATH, f"train_data.json_path={json_path}",
            f"attn_impl={TRAIN_ATTN_IMPL}"]


def full_entry_argv(json_path: str) -> list[str]:
    """The full finetune's command line: the YAML, its dataset's JSON and
    the batch that fits the card (``FULL_BATCH``)."""
    return ["--config", TRAIN_FULL_CONFIG_PATH, f"train_data.json_path={json_path}",
            f"train_batch_size={FULL_BATCH}"]


def write_clips(root: str, n: int = TRAIN_CLIPS, seed: int = 0) -> list[str]:
    """``n`` clips of ``FRAMES`` 512x512 PNG frames, each in its own
    directory: a static colour gradient with a band of red and blue stripes
    across the middle half that moves 16 px a frame (half the band's pixels
    change hue each frame: a motion score near 100, above the YAML's
    ``motion_threshold`` of 50)."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:RES, 0:RES]
    paths = []
    for i in range(n):
        tint = rng.integers(0, 160, 3)
        base = np.stack([(x * 96) // RES + tint[0], (y * 96) // RES + tint[1],
                         np.full_like(x, tint[2])], -1).astype(np.uint8)
        d = os.path.join(root, f"clip_{i:02d}")
        os.makedirs(d)
        for t in range(FRAMES):
            frame = base.copy()
            band = slice(RES // 4, 3 * RES // 4)
            red = ((x[band] + 16 * t + 8 * i) // 32) % 2 == 0
            frame[band] = np.where(red[..., None], np.array([220, 40, 40], np.uint8),
                                   np.array([40, 40, 220], np.uint8))
            Image.fromarray(frame).save(os.path.join(d, f"{t:04d}.png"))
        paths.append(d)
    return paths


def write_dataset_json(root: str, clips: list[str]) -> dict:
    """The JSON each YAML's dataset type reads: ``video_json`` (a list of
    {video, caption}) and ``video_blip`` ({data: [{video_path, data:
    [{frame_index, prompt}]}]}); → {type: path}."""
    import os

    prompts = [f"stripes drift right, clip {i}" for i in range(len(clips))]
    docs = {"video_json": [{"video": c, "caption": p} for c, p in zip(clips, prompts)],
            "video_blip": {"data": [{"video_path": c, "data": [{"frame_index": 0, "prompt": p}]}
                                    for c, p in zip(clips, prompts)]}}
    out = {}
    for kind, doc in docs.items():
        out[kind] = os.path.join(root, f"{kind}.json")
        with open(out[kind], "w") as f:
            json.dump(doc, f)
    return out


def _dir_bytes(path: str) -> int:
    import os

    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


@contextlib.contextmanager
def _captured_training(before_first=None, after_first=None):
    """Around ``cli.main``: each train step's seconds (to a device sync) and
    metrics, the t each step drew, the host's seconds blocked on the loader
    for each batch, each checkpoint / adapter / pipeline write (seconds,
    bytes) and preview (seconds), the arguments the step was made with and
    the state it trains; ``before_first(state, args)``'s result, taken
    before the first step, under ``"before"``, and ``after_first(state)``'s,
    taken after it, under ``"after"``."""
    import inspect

    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.train import trainer

    seen = {"steps": [], "t": [], "waits": [], "writes": [], "previews": [], "state": None,
            "args": None, "before": None, "after": None}
    saved = []

    def patch(mod, name, new):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, new)

    def maker(orig):
        def made(*args, **kw):
            seen["args"] = inspect.signature(orig).bind(*args, **kw).arguments
            step = orig(*args, **kw)

            def timed(state, batch, generator):
                if seen["state"] is None and before_first is not None:
                    seen["before"] = before_first(state, seen["args"])
                seen["state"] = state
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, batch, generator)
                torch.cuda.synchronize()
                seen["steps"].append((time.perf_counter() - t0, metrics))
                if len(seen["steps"]) == 1 and after_first is not None:
                    seen["after"] = after_first(state)
                return metrics
            return timed
        return made

    def drawn(*args, _orig=trainer.draw_inputs, **kw):
        noise, t, drop = _orig(*args, **kw)
        seen["t"].append(t.tolist())
        return noise, t, drop

    def prefetch(*args, _orig=cli.device_prefetch, **kw):
        it = _orig(*args, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            seen["waits"].append(time.perf_counter() - t0)
            yield batch

    def writer(name):
        orig = getattr(cli, name)

        def timed(path, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(path, *args, **kw)
            where = out if name == "save_checkpoint" else path
            seen["writes"].append((name, where, time.perf_counter() - t0, _dir_bytes(where)))
            return out
        return timed

    def preview(*args, _orig=cli.run_validation, **kw):
        t0 = time.perf_counter()
        out = _orig(*args, **kw)
        torch.cuda.synchronize()
        seen["previews"].append((time.perf_counter() - t0, out))
        return out

    patch(cli, "make_lora_train_step", maker(cli.make_lora_train_step))
    patch(cli, "make_train_step", maker(cli.make_train_step))
    patch(trainer, "draw_inputs", drawn)
    patch(cli, "device_prefetch", prefetch)
    for name in ("save_checkpoint", "save_lora", "save_pipeline"):
        patch(cli, name, writer(name))
    patch(cli, "run_validation", preview)
    try:
        yield seen
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)


def _train_run(tag: str, entry, argv: list, out_dir: str, before_first=None,
               after_first=None) -> tuple:
    """One training run through ``entry(argv + [output_dir=out_dir])`` (the
    port's ``train_lora`` or ``cli``) on the card, the launch counts reset
    before it and the peak memory counted from it: → (seen, launches, run
    directory, peak GiB)."""
    import os

    argv = argv + [f"output_dir={out_dir}"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _captured_training(before_first, after_first) as seen:
        t0 = time.perf_counter()
        entry(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    run_dir, = [os.path.join(out_dir, d) for d in os.listdir(out_dir)]
    times = [t for t, _ in seen["steps"]]
    for i, (sec, metrics) in enumerate(seen["steps"]):
        log(f"  {tag} step {i}: {sec:.3f} s, t {seen['t'][i]}  " + "  ".join(
            f"{k} {v:.6g}" for k, v in metrics.items()))
        bad = {k: v for k, v in metrics.items() if not v == v or abs(v) == float("inf")}
        # ε on a zero-terminal-SNR schedule: x̂0 divides by 0 at t = 999, in
        # JAX too (ROADMAP queue 3); anywhere else a non-finite value fails
        if bad and not (set(bad) <= {"loss", "motion_loss", "grad_norm"}
                        and 999 in seen["t"][i]):
            raise AssertionError(f"{tag} step {i}: non-finite {bad}")
    later = sorted(times[1:]) or times
    waits = seen["waits"]
    log(f"  {tag}: {len(times)} steps in {dt:.3f} s of run; s/step {later[len(later) // 2]:.3f} "
        f"(median of the steps after the first; the first {times[0]:.3f} s); peak device "
        f"memory {peak:.2f} GiB; the host blocked on the loader {sum(waits):.3f} s "
        f"({waits[0]:.3f} s for the first batch, {sum(waits[1:]):.3f} s for the "
        f"{len(waits) - 1} others)")
    for name, where, sec, nbytes in seen["writes"]:
        log(f"  {tag} {name}: {nbytes / 1e9:.4f} GB in {sec:.3f} s ({os.path.basename(where)})")
    for sec, metrics in seen["previews"]:
        log(f"  {tag} preview: {sec:.3f} s  {metrics}")
    log(f"  {tag} kernel launches: {launches}")
    return seen, launches, run_dir, peak


def _lora_snapshot(state, args) -> dict:
    """Host copies of the frozen weights a LoRA run must not change: the
    fp32 base of the adapted kernels and every UNet parameter."""
    return {"base": _host(args["base"]), "unet": _host(dict(args["unet"].named_parameters()))}


def _zero_ups(state) -> tuple:
    """(adapted kernels whose ``up`` is all zero, adapted kernels)."""
    ups = [t for n, t in state.masters.items() if n.endswith(".up")]
    return sum(int(not bool(t.any())) for t in ups), len(ups)


def _state_snapshot(state, args) -> dict:
    return {"masters": _host(state.masters), "optimizer": {
        key: _host(getattr(state.optimizer, key)) for key in state.optimizer.STATE},
        "step": state.step}


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def run_train_entry() -> dict:
    """The training entry points of the port at full width (bf16, 512 px,
    16 frames, random weights: the YAMLs' checkpoint directory and datasets
    are not in the repository), on ``TRAIN_CLIPS`` synthetic clips (frame
    directories of PNGs) written under ``build/``, each YAML's values but
    ``train_data.json_path``, ``output_dir``, the step counts and
    ``attn_impl`` (``TRAIN_ATTN_IMPL``): ``run_lora_entry``, then
    ``run_full_entry``. Returns each kernel's launch count during the LoRA
    run (a) and during the full finetune (d), as {"lora": …, "full": …}."""
    import os
    import shutil
    import tempfile

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_entry_", dir="build")
    try:
        t0 = time.perf_counter()
        clips = write_clips(os.path.join(work, "clips"))
        json_paths = write_dataset_json(work, clips)
        log(f"train entry points: {len(clips)} synthetic clips of {FRAMES} PNG frames at "
            f"{RES}x{RES} written in {time.perf_counter() - t0:.3f} s")
        lora = run_lora_entry(work, json_paths["video_json"])
        full = run_full_entry(work, json_paths["video_blip"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"lora": lora, "full": full}


def run_lora_entry(work: str, json_path: str) -> dict:
    """(a) ``train_lora`` at ``configs/train_mask_motion_lora.yaml`` (batch 4,
    rank 16 over every dense kernel of the UNet), ``LORA_STEPS`` steps with a
    checkpoint every ``LORA_CKPT_STEPS`` and the step-5 preview: every loss
    finite, every grad norm > 0, every ``up`` matrix non-zero after step 1,
    the base weights bit-equal to theirs before step 1, adapter files and
    ``ckpt/`` at steps 3 and 6, kernels 1-5 and the flash backward and no
    other; (b) the same command resumed from (a)'s ``ckpt/`` to
    ``LORA_RESUME_STEPS``: it starts at step 6 with (a)'s adapter and moments
    bit for bit, takes 2 steps and launches the kernels (a) launches; (c) ``main_eval`` with (a)'s step-6
    adapter file: the merged UNet equal to a merge of (a)'s in-memory
    adapter bit for bit, the video finite, kernels 1-5 only. Under ``work``;
    returns (a)'s launch counts."""
    import os
    import shutil

    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.core.config import Config
    from animate_anything_tpu_torch.models.lora import collapse_lora_
    from animate_anything_tpu_torch.train_lora import train_lora

    lora_argv = lora_entry_argv(json_path)
    (a, launches, run_a, peak_a) = _train_run(
        "(a) train_lora", train_lora,
        lora_argv + [f"max_train_steps={LORA_STEPS}",
                     f"checkpointing_steps={LORA_CKPT_STEPS}"],
        os.path.join(work, "lora"), _lora_snapshot, _zero_ups)
    state = a["state"]
    if len(a["steps"]) != LORA_STEPS or state.step != LORA_STEPS:
        raise AssertionError(f"(a): {len(a['steps'])} steps, state at {state.step}")
    if not all(m["grad_norm"] > 0 for _, m in a["steps"]):
        raise AssertionError("(a): a step with grad_norm 0")
    zero, kernels = a["after"]
    log(f"  (a): {kernels} adapted kernels, {zero} up matrices still zero after step 1; "
        f"adapter {sum(t.numel() for t in state.masters.values()) / 1e6:.2f} M params, "
        f"optimizer state {state.optimizer.state_bytes() / 1e6:.1f} MB")
    if zero:
        raise AssertionError(f"(a): {zero} of {kernels} up matrices zero after step 1")
    args = a["args"]
    after = {"base": _host(args["base"]), "unet": _host(dict(args["unet"].named_parameters()))}
    for key in ("base", "unet"):
        if not _equal(after[key], a["before"][key]):
            raise AssertionError(f"(a): the frozen {key} weights changed")
    log("  (a): the fp32 base of the adapted kernels and every UNet parameter bit-equal to "
        "their values before step 1")
    want = {f"lora_step_{s}.safetensors" for s in (LORA_CKPT_STEPS, LORA_STEPS)}
    ckpts = sorted(os.listdir(os.path.join(run_a, "ckpt")))
    if not want <= set(os.listdir(run_a)) or ckpts != [
            f"step_{s:08d}" for s in (LORA_CKPT_STEPS, LORA_STEPS)]:
        raise AssertionError(f"(a): run directory {sorted(os.listdir(run_a))}, ckpt {ckpts}")
    if len(a["previews"]) != 1:
        raise AssertionError(f"(a): {len(a['previews'])} previews, the YAML asks for one")
    require_only("(a) train_lora", launches, TRAIN_ENTRY_KERNELS)
    saved_a = _state_snapshot(state, None)
    adapter = state.params["unet_lora"]
    del a, state, args, after

    (b, launches_b, _, _) = _train_run(
        "(b) train_lora resumed", train_lora,
        lora_argv + [f"max_train_steps={LORA_RESUME_STEPS}",
                     f"checkpointing_steps={LORA_CKPT_STEPS}",
                     f"resume_from_checkpoint={os.path.join(run_a, 'ckpt')}"],
        os.path.join(work, "lora_resumed"), _state_snapshot)
    restored = b["before"]
    if restored["step"] != LORA_STEPS or len(b["steps"]) != LORA_RESUME_STEPS - LORA_STEPS:
        raise AssertionError(f"(b): resumed at {restored['step']}, {len(b['steps'])} steps")
    if not _equal(restored["masters"], saved_a["masters"]) or not all(
            _equal(restored["optimizer"][k], saved_a["optimizer"][k])
            for k in saved_a["optimizer"]):
        raise AssertionError("(b): the restored adapter or moments differ from (a)'s")
    require_only("(b) train_lora resumed", launches_b, TRAIN_ENTRY_KERNELS)
    log(f"  (b): resumed at step {restored['step']} with (a)'s adapter and moments bit for "
        f"bit; {len(b['steps'])} steps")
    del b, restored

    lora_file = os.path.join(run_a, f"lora_step_{LORA_STEPS}.safetensors")
    eval_cfg = dict(cli.load_config(TRAIN_LORA_CONFIG_PATH).to_dict(),
                    output_dir=os.path.join(work, "eval"), attn_impl=TRAIN_ATTN_IMPL,
                    lora_path=lora_file)
    models_out = []
    _eval_run("(c) main_eval with lora_path", eval_cfg, models_out)
    got = models_out.pop()["unet"].state_dict()
    ref = cli.build_models(eval_cfg["pretrained_model_path"], motion_mask=True,
                           motion_strength=True, compute_dtype=torch.float32,
                           attn_impl=TRAIN_ATTN_IMPL)
    collapse_lora_(ref["unet"], adapter, cli.lora_configs(Config(eval_cfg))[0])
    want_sd = cli._cast(ref, cli.policy_from_string("bf16"))["unet"].state_dict()
    if set(got) != set(want_sd) or not all(
            got[k].dtype == want_sd[k].dtype and torch.equal(got[k], want_sd[k])
            for k in want_sd):
        raise AssertionError("(c): main_eval's merged UNet differs from a merge of (a)'s "
                             "in-memory adapter")
    log("  (c): main_eval's merged UNet equals a merge of (a)'s in-memory adapter bit for "
        "bit")
    del got, ref, want_sd, adapter
    shutil.rmtree(os.path.join(work, "lora_resumed"), ignore_errors=True)
    return launches


def run_full_entry(work: str, json_path: str) -> dict:
    """(d) ``cli`` (``train.py``) at ``configs/train_mask_motion.yaml``, batch
    ``FULL_BATCH``, ``FULL_STEPS`` steps with the end-of-run checkpoint and
    pipeline directory, each write's bytes and seconds, both removed after;
    (e) one step of (d) with ``use_8bit_adam=true``: its peak memory and
    optimizer-state bytes beside (d)'s. Each run launches kernels 1-5 and
    the flash backward and no other; returns (d)'s launch counts."""
    import os
    import shutil

    from animate_anything_tpu_torch import cli

    full_argv = full_entry_argv(json_path)
    need = 17e9 + 7.4e9
    free = shutil.disk_usage(work).free
    log(f"  (d): {free / 1e9:.1f} GB free under {work}, about {need / 1e9:.1f} GB to write")
    if free < 1.5 * need:
        raise AssertionError(f"(d): {free / 1e9:.1f} GB free, {need / 1e9:.1f} GB to write")
    (d, launches_d, _, peak_d) = _train_run(
        f"(d) train.py batch {FULL_BATCH}", cli.cli,
        full_argv + [f"max_train_steps={FULL_STEPS}"], os.path.join(work, "full"))
    if len(d["steps"]) != FULL_STEPS or not any(
            name == "save_pipeline" for name, *_ in d["writes"]):
        raise AssertionError(f"(d): {len(d['steps'])} steps, writes {d['writes']}")
    require_only("(d) train.py", launches_d, TRAIN_ENTRY_KERNELS)
    bytes_d = d["state"].optimizer.state_bytes()
    del d
    shutil.rmtree(os.path.join(work, "full"), ignore_errors=True)

    (e, launches_e, _, peak_e) = _train_run(
        f"(e) train.py batch {FULL_BATCH}, 8-bit AdamW", cli.cli,
        full_argv + ["max_train_steps=1", "use_8bit_adam=true",
                     "save_pretrained_model=false"], os.path.join(work, "full_8bit"))
    require_only("(e) train.py, 8-bit AdamW", launches_e, TRAIN_ENTRY_KERNELS)
    n_params = sum(t.numel() for t in e["state"].masters.values())
    bytes_e = e["state"].optimizer.state_bytes()
    log(f"  (e) against (d): peak device memory {peak_e:.2f} against {peak_d:.2f} GiB; "
        f"optimizer state {bytes_e / 1e9:.3f} GB ({bytes_e / n_params:.3f} bytes a "
        f"parameter) against {bytes_d / 1e9:.3f} GB ({bytes_d / n_params:.3f}), "
        f"{n_params / 1e9:.4f} B trained parameters")
    del e
    return launches_d


# ---------------------------------------------------------------------------
# SVD training (``train_svd.py`` without --eval) and the stage-2 entry point
# ---------------------------------------------------------------------------

SVD_TRAIN_KERNELS = SVD_KERNELS + ("flash_attention_bwd",)
# The YAML's train_batch_size, and 3 steps with one checkpoint at the end.
SVD_TRAIN_BATCH = 3
SVD_TRAIN_STEPS = 3
# A kernel-backed SVD block's gradients against the same block's with every
# kernel swapped for its plain version (``plain_launches``), bf16 inputs and
# weights on the card: the two forwards round to bf16 at the same places,
# but a kernel's fp32 accumulation order differs from cuBLAS's, and the
# backward's twins then differentiate at inputs one bf16 ulp apart here and
# there. Held per gradient tensor as ‖g_kernel − g_plain‖ / ‖g_plain‖.
SITE_GRAD_REL = 2e-2
# A small SVD UNet's gradients with per-block checkpointing against
# without it, on the card: the recomputed forward is the same kernels on the
# same inputs, so only cuDNN's and cuBLAS's backward algorithms may differ.
CKPT_GRAD_REL = 1e-2


@contextlib.contextmanager
def plain_launches():
    """Kernels 1-3 and 5 (and the flash backward) replaced by their plain
    versions on CUDA tensors, inside the same wrappers and autograd
    Functions: what a kernel-backed module is held against on the card.
    Nothing launched here is counted."""
    from animate_anything_tpu_torch.ops import flash_attention as fa
    from animate_anything_tpu_torch.ops import geglu
    from animate_anything_tpu_torch.ops import temporal_block as tb
    from animate_anything_tpu_torch.ops import temporal_conv as tc

    swaps = ((fa, "flash_forward_with_lse",
              lambda q, k, v, with_lse=True, prescaled=False: (fa.attention_reference(q, k, v),
                                                               None)),
             (fa, "flash_attention_backward",
              lambda q, k, v, o, do, lse=None: fa.flash_attention_backward_reference(
                  q, k, v, o, do)),
             (geglu, "_launch", geglu.ln_geglu_reference), (tb, "_launch", tb._reference),
             (tc, "_launch", tc.tap_conv_reference))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _randomize_(module, gen) -> None:
    """Weights ~ N(0, 1/fan_in), norm scales 1 ± 0.1, biases and the
    mixers' logits ± 0.1 (nothing zero, so every gradient path carries)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if p.ndim >= 2:
                p.copy_(noise / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def _grads_of(module, call, inputs, cot) -> tuple:
    """(output, {name: fp32 gradient}) of ``(call(module, *inputs) ·
    cot).sum()``, the inputs' gradients under ``input i``."""
    for p in module.parameters():
        p.grad = None
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = call(module, *xs)
    (out.float() * cot).sum().backward()
    grads = {name: p.grad.float() for name, p in module.named_parameters()}
    grads.update({f"input {i}": x.grad.float() for i, x in enumerate(xs)})
    return out.detach().float(), grads


def check_svd_site_grads(gen, rows: list[dict]) -> None:
    """The SVD training path's backward at full-width sites, on the card:

    - the flash backward at the training step's b·f = 42 (batch 3 × 14
      frames) at the three spatial self-attention levels, called twice (bit
      for bit), held against its plain version and timed beside SDPA's
      backward, into the row's ``svd_train_*`` numbers;
    - ``SpatioTemporalResBlock`` (kernel 3, both stages, the second with the
      residual, eps 1e-6) and ``TransformerSpatioTemporalModel`` (kernel 1
      and its backward, kernel 2 ×3, kernel 5 at f = 14) at the 32×32 level
      (c = 640, 10 heads, one sample of 14 frames), every parameter's and
      input's gradient against the same block's with the kernels swapped for
      their plain versions (``plain_launches``), within ``SITE_GRAD_REL``."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models.svd_unet import (SpatioTemporalResBlock,
                                                            TransformerSpatioTemporalModel)
    from animate_anything_tpu_torch.utils.kernel_sites import SVD_FLASH_SITES, SVD_FRAMES

    bf = SVD_TRAIN_BATCH * SVD_FRAMES
    log(f"SVD training sites (b·f = {bf}): the flash backward, kernel vs plain version:")
    tally = Tally("flash_attention_bwd", "", "")
    for s, h, _ in SVD_FLASH_SITES:
        _flash_bwd_case(gen, bf, s, s, h, 64, tally)
        torch.cuda.empty_cache()
    row = next(r for r in rows if r["name"] == "flash_attention_bwd")
    row["max_abs_err"] = max(row["max_abs_err"], tally.row["max_abs_err"])
    row.update(svd_train_ms=tally.row["ms"], svd_train_plain_ms=tally.row["plain_ms"],
               svd_train_bound_ms=tally.row["bound_ms"],
               svd_train_library_ms=tally.row["library_ms"])

    f, hw, c, heads = SVD_FRAMES, 32, 640, 10
    x = torch.randn(f, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
    temb = torch.randn(f, 4 * 320, generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn(1, 1, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.device("cuda"):
        blocks = (("SpatioTemporalResBlock", SpatioTemporalResBlock(c, c, 4 * 320, 1e-5, "pallas"),
                   (x, temb), ("tap_conv",)),
                  ("TransformerSpatioTemporalModel",
                   TransformerSpatioTemporalModel(c, heads, c // heads, 1024, "pallas"), (x, ctx),
                   ("flash_attention", "flash_attention_bwd", "ln_geglu_ff", "temporal_block")))
    for name, block, inputs, kernels in blocks:
        _randomize_(block, gen)
        cast_module_(block)
        cot = torch.randn(f, hw, hw, c, generator=gen, device="cuda") / (f * hw * hw) ** 0.5
        call = lambda m, *a: m(*a, f)  # noqa: E731
        before = read_counts()
        out, got = _grads_of(block, call, inputs, cot)
        launched = {k: v - before[k] for k, v in read_counts().items()}
        with plain_launches():
            want_out, want = _grads_of(block, call, inputs, cot)
        torch.cuda.synchronize()
        require_only(f"{name} forward + backward (f = {f})", launched, kernels)
        fwd = _rel_rms(out, want_out)
        rel = {k: float((got[k] - g).norm() / g.norm()) for k, g in want.items()
               if float(g.norm()) > 0}
        worst = max(rel, key=rel.get)
        launched = {k: v for k, v in launched.items() if v}
        log(f"  {name} at b·f = {f}, {hw}x{hw}, c = {c}: forward relative RMS {fwd:.3g}; "
            f"{len(rel)} gradients, worst {worst} {rel[worst]:.3g} (limit {SITE_GRAD_REL}), "
            f"median {sorted(rel.values())[len(rel) // 2]:.3g}; launches {launched}")
        if fwd > Y_RTOL or rel[worst] > SITE_GRAD_REL:
            raise AssertionError(f"{name}: kernel-backed gradients disagree with the plain "
                                 f"versions' ({worst}: {rel[worst]:.3g}, forward {fwd:.3g})")
        del block, got, want, out, want_out
        torch.cuda.empty_cache()


def check_svd_checkpointing(seed: int = 2) -> None:
    """A small SVD UNet (head dim 32, 14 frames, 32×32 latents: kernel 1 at
    s = 1024 and 256, 9 channels, batch 2) in bf16 on the card through
    kernels 1, 2, 3, 5 and the flash backward: every gradient with
    ``gradient_checkpointing`` on against off (``CKPT_GRAD_REL``), and the
    peak device memory of the forward and backward with it on and off."""
    from animate_anything_tpu_torch.core.dtypes import cast_module_
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(in_channels=9, num_attention_heads=(1, 2, 2, 2), attn_impl="pallas")
    with torch.device("cuda"):
        model = UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny(**kw))
    _randomize_(model, gen)
    cast_module_(model)
    b, f, hw = 2, 14, 32
    sample = torch.randn(b, f, hw, hw, 9, generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn(b, 1, 32, generator=gen, device="cuda").to(torch.bfloat16)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * b, device="cuda")
    cot = torch.randn(b, f, hw, hw, 4, generator=gen, device="cuda") / (b * f * hw * hw) ** 0.5
    grads, peaks = {}, {}
    for remat in (False, True):
        with torch.device("meta"):
            unet = UNetSpatioTemporalConditionModel(
                SVDUNetConfig.tiny(**kw, gradient_checkpointing=remat))
        unet.load_state_dict(model.state_dict(), assign=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = unet(sample, torch.tensor(0.3, device="cuda"), ctx, ids)
        (out.float() * cot).sum().backward()
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**20
        grads[remat] = {n: p.grad.float() for n, p in unet.named_parameters()}
        del out, unet
    rel = {n: float((grads[True][n] - g).norm() / g.norm()) for n, g in grads[False].items()
           if float(g.norm()) > 0}
    worst = max(rel, key=rel.get)
    equal = sum(torch.equal(grads[True][n], g) for n, g in grads[False].items())
    log(f"small SVD UNet (14 frames, 32x32 latents, batch 2) on the card, checkpointing on vs "
        f"off: {equal} of {len(grads[False])} gradients bit-equal, worst {worst} {rel[worst]:.3g} "
        f"(limit {CKPT_GRAD_REL}); peak memory above the weights {peaks[True]:.1f} MiB on "
        f"against {peaks[False]:.1f} MiB off")
    if rel[worst] > CKPT_GRAD_REL:
        raise AssertionError(f"SVD checkpointing changes the gradients: {worst} {rel[worst]:.3g}")
    if peaks[True] >= peaks[False]:
        raise AssertionError(f"SVD checkpointing saves no memory: {peaks[True]:.1f} MiB on, "
                             f"{peaks[False]:.1f} MiB off")


@contextlib.contextmanager
def _captured_svd_training():
    """Around ``cli_svd.main``: each train step's seconds (to a device sync),
    metrics and kernel launches, the host's seconds blocked on the loader
    for each batch and in the CLIP preprocessing, each write's seconds and
    bytes, the model build's seconds and the state it trains."""
    from animate_anything_tpu_torch import cli_svd

    seen = {"steps": [], "waits": [], "clip": [], "writes": [], "build": [], "state": None}
    saved = []

    def patch(name, new):
        saved.append((name, getattr(cli_svd, name)))
        setattr(cli_svd, name, new)

    def maker(*args, _orig=cli_svd.make_svd_train_step, **kw):
        step = _orig(*args, **kw)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            before = read_counts()
            t0 = time.perf_counter()
            metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            seen["steps"].append((dt, metrics,
                                  {k: v - before[k] for k, v in read_counts().items()}))
            return metrics
        return timed

    def prefetch(*args, _orig=cli_svd.device_prefetch, **kw):
        it = _orig(*args, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            seen["waits"].append(time.perf_counter() - t0)
            yield batch

    def clip(*args, _orig=cli_svd.preprocess_clip_image, **kw):
        t0 = time.perf_counter()
        out = _orig(*args, **kw)
        seen["clip"].append(time.perf_counter() - t0)
        return out

    def writer(name):
        orig = getattr(cli_svd, name)

        def timed(path, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(path, *args, **kw)
            seen["writes"].append((name, out, time.perf_counter() - t0, _dir_bytes(out)))
            return out
        return timed

    def build(*args, _orig=cli_svd.build_svd_models, **kw):
        t0 = time.perf_counter()
        out = _orig(*args, **kw)
        torch.cuda.synchronize()
        seen["build"].append(time.perf_counter() - t0)
        return out

    def state(*args, _orig=cli_svd.create_train_state):
        seen["state"] = _orig(*args)
        return seen["state"]

    patch("make_svd_train_step", maker)
    patch("device_prefetch", prefetch)
    patch("preprocess_clip_image", clip)
    patch("save_checkpoint", writer("save_checkpoint"))
    patch("_save_svd_pipeline", writer("_save_svd_pipeline"))
    patch("build_svd_models", build)
    patch("create_train_state", state)
    try:
        yield seen
    finally:
        for name, orig in reversed(saved):
            setattr(cli_svd, name, orig)


def run_svd_train_entry() -> dict:
    """``train_svd.py`` without ``--eval`` (``cli_svd.cli``) at
    ``configs/train_svd_mask.yaml``: full width, 14 frames at 512 px, batch
    ``SVD_TRAIN_BATCH``, ``gradient_checkpointing``, ``attn_impl: pallas``,
    bf16, random weights (JAX's ``build_svd_models`` draws them), on
    ``TRAIN_CLIPS`` synthetic ``video_blip`` clips (PNG frame directories)
    under ``build/``; ``SVD_TRAIN_STEPS`` steps with the checkpoint and the
    pipeline written once, at the end. Every step: a finite loss, a grad
    norm > 0, kernels 1, 2, 3, 5 and the flash backward launched and no
    other. The saved ``unet/`` equals the trained fp32 masters bit for bit.
    Prints s/step, peak memory, the host's wait on the loader and in the
    CLIP preprocessing, the writes' bytes and seconds. Returns the run's
    launch counts."""
    import math
    import os
    import shutil
    import tempfile

    from safetensors.torch import load_file

    from animate_anything_tpu_torch import cli_svd

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="svd_train_", dir="build")
    try:
        t0 = time.perf_counter()
        clips = write_clips(os.path.join(work, "clips"))
        json_path = write_dataset_json(work, clips)["video_blip"]
        log(f"SVD training entry point: cli_svd.cli({SVD_CONFIG_PATH}, no --eval), batch "
            f"{SVD_TRAIN_BATCH}, {SVD_TRAIN_STEPS} steps; {len(clips)} synthetic clips written in "
            f"{time.perf_counter() - t0:.3f} s")
        argv = ["--config", SVD_CONFIG_PATH, f"train_data.json_path={json_path}",
                f"train_batch_size={SVD_TRAIN_BATCH}", f"max_train_steps={SVD_TRAIN_STEPS}",
                f"checkpointing_steps={SVD_TRAIN_STEPS}", f"output_dir={work}/out"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _captured_svd_training() as seen:
            t0 = time.perf_counter()
            cli_svd.cli(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        state = seen["state"]
        if len(seen["steps"]) != SVD_TRAIN_STEPS or state.step != SVD_TRAIN_STEPS:
            raise AssertionError(f"SVD training: {len(seen['steps'])} steps, state at "
                                 f"{state.step}")
        for i, (sec, metrics, counts) in enumerate(seen["steps"]):
            log(f"  step {i}: {sec:.3f} s  " + "  ".join(f"{k} {v:.6g}"
                                                         for k, v in metrics.items()))
            log(f"  step {i} launches: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
            if not all(math.isfinite(v) for v in metrics.values()) or metrics["grad_norm"] <= 0:
                raise AssertionError(f"SVD training step {i}: {metrics}")
            require_only(f"SVD training step {i}", counts, SVD_TRAIN_KERNELS)
        times = [sec for sec, _, _ in seen["steps"]]
        later = sorted(times[1:])
        waits = seen["waits"]
        log(f"  {len(times)} steps in {dt:.3f} s of run (the model build {seen['build'][0]:.3f} "
            f"s); s/step {later[len(later) // 2]:.3f} (median of the steps after the first; the "
            f"first {times[0]:.3f} s); peak device memory {peak:.2f} GiB; the host blocked on "
            f"the loader {sum(waits):.3f} s ({waits[0]:.3f} s for the first batch) and in the "
            f"CLIP preprocessing {sum(seen['clip']):.3f} s ({len(seen['clip'])} frames); "
            f"{sum(t.numel() for t in state.masters.values()) / 1e9:.4f} B trained parameters, "
            f"optimizer state {state.optimizer.state_bytes() / 1e9:.3f} GB")
        for name, where, sec, nbytes in seen["writes"]:
            log(f"  {name}: {nbytes / 1e9:.4f} GB in {sec:.3f} s ({os.path.basename(where)})")
        require_only("SVD training", launches, SVD_TRAIN_KERNELS)
        pipe_dir, = [w for n, w, _, _ in seen["writes"] if n == "_save_svd_pipeline"]
        saved = load_file(os.path.join(pipe_dir, "unet", "diffusion_pytorch_model.safetensors"))
        if set(saved) != set(state.masters) or not all(
                torch.equal(saved[k], state.masters[k].cpu()) for k in saved):
            raise AssertionError("SVD training: the saved unet/ differs from the trained masters")
        log(f"  the saved unet/ ({len(saved)} tensors, fp32) equals the trained masters bit for "
            f"bit; launches {launches}")
        del state, seen, saved
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


STAGE2_CONFIG_PATH = "configs/layerdiffuse_stage2_384.yaml"
# The stage-2 YAML names no attn_impl (JAX's default "xla" runs no kernel);
# the phase passes pallas, as the LoRA runs do.
STAGE2_ATTN_IMPL = "pallas"
# The 9-channel Concat pipeline's short run: steps.
STAGE2_CONCAT_STEPS = 3
# Two identical stage-2 requests: while kernels 3 and 4 summed Σy, Σy² with
# fp32 atomics, whose order changed the GroupNorm statistics that read them
# in the last bits, 25 steps under CFG 9 carried that on (two runs on the
# H100 read a relative RMS of 0.0225 and 0.0034 over the latents). Their
# sums now have one order, so the runs must also be bit-equal; the bound
# stays.
STAGE2_RUN_TO_RUN_REL = 1e-1


def _stage2_counts_per_request(steps: int) -> dict:
    """Each kernel's launches in a stage-2 request of ``steps`` CFG forwards
    (the sites' counts of ``utils/kernel_sites.STAGE2_*``, pinned on the
    meta device by ``tests/test_torch_port_stage2_sites.py``)."""
    from animate_anything_tpu_torch.utils import kernel_sites as ks

    per = {"flash_attention": sum(k for *_, k in ks.STAGE2_FLASH_SITES),
           "ln_geglu_ff": sum(k for *_, k in ks.STAGE2_GEGLU_SITES),
           "tap_conv": sum(k for *_, k in ks.STAGE2_TAP_SITES),
           "proj_residual_stats": sum(k for *_, k in ks.STAGE2_PROJ_SITES),
           "temporal_block": sum(k for *_, k in ks.STAGE2_BLOCK_SITES)}
    return {name: steps * k for name, k in per.items()}


@contextlib.contextmanager
def _captured_stage2():
    """Around ``cli_stage2.main_eval``: the model builds' seconds (and the
    models), each pipeline call's (video, latents, rgba) on the host and its
    seconds, the outputs' write seconds."""
    from animate_anything_tpu_torch import cli_stage2
    from animate_anything_tpu_torch.pipelines.stage2 import MaskedLatentToVideoPipeline

    seen = {"build": [], "models": [], "requests": [], "writes": []}
    orig_call = MaskedLatentToVideoPipeline.__call__
    saved = []

    def timed(name, key, keep=False):
        orig = getattr(cli_stage2, name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            seen[key].append(time.perf_counter() - t0)
            if keep:
                seen["models"].append(out)
            return out
        saved.append((name, orig))
        setattr(cli_stage2, name, run)

    def recorded(self, *args, **kw):
        t0 = time.perf_counter()
        video, latents, rgba = orig_call(self, *args, **kw)
        torch.cuda.synchronize()
        seen["requests"].append((video.float().cpu(), latents.float().cpu(), rgba.cpu(),
                                 time.perf_counter() - t0))
        return video, latents, rgba

    timed("build_models", "build", keep=True)
    timed("build_transparent_vae", "build")
    timed("save_rgba_outputs", "writes")
    MaskedLatentToVideoPipeline.__call__ = recorded
    try:
        yield seen
    finally:
        MaskedLatentToVideoPipeline.__call__ = orig_call
        for name, orig in reversed(saved):
            setattr(cli_stage2, name, orig)


def _stage2_run(tag: str, cfg: dict, steps: int) -> tuple:
    """``cli_stage2.main_eval(**cfg)`` once on the card → (rgba, latents,
    launches, the UNet it built): the outputs finite and of their shapes,
    alpha in {0, 255}, the gif and both webps written, a finite latent
    motion score, kernels 1-5 launched exactly ``steps`` CFG forwards'
    worth (``_stage2_counts_per_request``) and no other."""
    import math
    import os

    from animate_anything_tpu_torch.cli_stage2 import main_eval

    vd = cfg["validation_data"]
    frames, res = int(vd["num_frames"]), int(vd["width"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _captured_stage2() as seen:
        t0 = time.perf_counter()
        out = main_eval(**cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    (video, latents, rgba, request), = seen["requests"]
    if tuple(rgba.shape) != (1, frames, res, res, 4) or not torch.isfinite(rgba).all() or \
            not torch.isfinite(latents).all():
        raise AssertionError(f"{tag}: rgba {tuple(rgba.shape)}, finite "
                             f"{bool(torch.isfinite(rgba).all())}")
    alpha = set(torch.unique(rgba[..., 3]).tolist())
    if not alpha <= {0.0, 255.0} or not all(os.path.isfile(out[k])
                                            for k in ("gif", "rgba", "alpha")):
        raise AssertionError(f"{tag}: alpha values {sorted(alpha)[:5]}, outputs {out}")
    if not math.isfinite(out["latent_motion_score"]):
        raise AssertionError(f"{tag}: latent motion score {out['latent_motion_score']}")
    build = sum(seen["build"])
    write, = seen["writes"]
    log(f"  {tag}: main_eval {dt:.3f} s (the model builds {build:.3f} s, the request "
        f"{request:.3f} s, the gif and webp writes {write:.3f} s), peak device memory "
        f"{peak:.2f} GiB; alpha share {float((rgba[..., 3] > 0).float().mean()):.3f}, latent "
        f"motion score {out['latent_motion_score']:.4g}; launches {launches}")
    want = _stage2_counts_per_request(steps)
    require_only(tag, launches, FORWARD_KERNELS)
    got = {name: launches[name] for name in FORWARD_KERNELS}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    return rgba, latents, launches, seen["models"][0]["unet"]


def explain_stage2_spread(unet, seed: int = 12) -> None:
    """Where two identical stage-2 requests part: one CFG forward of the
    stage-2 UNet at the request's shapes (2 × 8 frames, 48×48 latents) with
    every kernel launched twice a call on the same inputs
    (``_launched_twice``). Raises, naming the kernels whose two results
    differ, or, where every kernel is bit-stable, saying the spread comes
    from another op."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inputs = (torch.randn(2, 8, 48, 48, 4, generator=gen, device="cuda"), 500,
              torch.randn(2, 77, 1024, generator=gen, device="cuda"),
              torch.randn(2, 1, 48, 48, 4, generator=gen, device="cuda"),
              torch.ones(2, 1, 48, 48, 1, device="cuda"), torch.tensor([5.0, 5.0], device="cuda"))
    with torch.no_grad(), _launched_twice() as seen:
        unet(*inputs)
    torch.cuda.synchronize()
    for name, rec in seen.items():
        log(f"  {name}: {rec['differ']} of {rec['calls']} calls gave another result on the same "
            f"inputs; max |diff| by output {[f'{v:.3g}' for v in rec['max_abs']]}")
    wrong = {name: rec["max_abs"] for name, rec in seen.items()
             if rec["calls"] == 0 or rec["differ"]}
    if wrong:
        raise AssertionError(f"stage-2 run to run: kernels give another result on the same "
                             f"inputs (or never ran): {wrong}")
    raise AssertionError("stage-2 run to run: every kernel is bit-stable on the same inputs; "
                         "another op parts the two requests")


def run_stage2_entry() -> dict:
    """``train_transparent_i2v_stage2.py --eval`` (``cli_stage2.main_eval``)
    at ``configs/layerdiffuse_stage2_384.yaml`` with ``attn_impl=pallas``
    (full width, 384 px, 8 frames, 25 DPM-Solver++ steps, CFG 9, bf16; random
    weights and the seeded random RGBA image: the YAML's checkpoint and
    image are absent):

    (a) twice, kernels 1-5 at exactly 25 CFG forwards' worth each run; the
        two runs' latents within ``STAGE2_RUN_TO_RUN_REL`` and bit-equal,
        latents and RGBA frames (a difference is traced by
        ``explain_stage2_spread``, which fails the run), the alpha flips
        counted;
    (b) the 9-channel Concat pipeline through a ``unet/config.json`` with
        ``condition_mode: channel_concat`` (a full-width UNet written in fp32
        under ``build/``, then read by ``main_eval`` with ``in_channels=9``),
        ``STAGE2_CONCAT_STEPS`` steps, its exact counts.

    Returns each kernel's launch count during (a)'s first run."""
    import os
    import shutil
    import tempfile

    import PIL.features

    from animate_anything_tpu_torch.core.config import load_config
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.train.checkpoint import save_pipeline
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    webp = PIL.features.check("webp")
    log(f"stage-2 entry point: cli_stage2.main_eval({STAGE2_CONFIG_PATH}, attn_impl="
        f"{STAGE2_ATTN_IMPL}); PIL {PIL.__version__} webp support {webp}")
    if not webp:
        raise AssertionError("this machine's PIL cannot write webp")
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="stage2_", dir="build")
    try:
        cfg = dict(load_config(STAGE2_CONFIG_PATH).to_dict(), attn_impl=STAGE2_ATTN_IMPL,
                   output_dir=os.path.join(work, "out"))
        steps = int(cfg["validation_data"]["num_inference_steps"])
        rgba, latents, launches, _ = _stage2_run("main_eval (a)", cfg, steps)
        rgba2, latents2, _, unet = _stage2_run("main_eval (a), again", cfg, steps)
        rel = _rel_rms(latents2, latents)
        flips = int((rgba2[..., 3] != rgba[..., 3]).sum())
        log(f"  run to run: latents max |diff| {_err(latents2, latents):.4g}, relative RMS "
            f"{rel:.3g} (limit {STAGE2_RUN_TO_RUN_REL}); colour max |diff| "
            f"{_err(rgba2[..., :3], rgba[..., :3]):.4g} of 255; {flips} of "
            f"{rgba[..., 3].numel()} alpha values flipped")
        if rel > STAGE2_RUN_TO_RUN_REL:
            raise AssertionError(f"stage-2 main_eval: two runs {rel:.3g} apart")
        if not (torch.equal(latents2, latents) and torch.equal(rgba2, rgba)):
            explain_stage2_spread(unet)
        log("  the two runs are bit-equal (latents and RGBA frames)")
        del rgba, rgba2, latents, latents2, unet

        ccfg = UNet3DConfig(motion_mask=True, motion_strength=True, attn_impl=STAGE2_ATTN_IMPL,
                            condition_mode="channel_concat")
        with torch.device("cuda"):
            unet = UNet3DConditionModel(ccfg)
        init_unet3d_(unet, torch.Generator(device="cuda").manual_seed(3))
        ckpt = os.path.join(work, "concat_ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = save_pipeline(ckpt, unet, ccfg)
        log(f"  (b) a channel-concat UNet's unet/ written: {nbytes / 1e9:.3f} GB in "
            f"{time.perf_counter() - t0:.3f} s")
        del unet
        vd = dict(cfg["validation_data"], num_inference_steps=STAGE2_CONCAT_STEPS)
        concat_cfg = dict(cfg, in_channels=9, pretrained_model_path=ckpt, validation_data=vd,
                          output_dir=os.path.join(work, "concat"))
        _, _, _, unet = _stage2_run("(b) main_eval, in_channels=9 (Concat)", concat_cfg,
                                    STAGE2_CONCAT_STEPS)
        if unet.config.condition_mode != "channel_concat" or unet.conv_in2.weight.shape[1] != 9:
            raise AssertionError(f"(b): the UNet built is {unet.config.condition_mode}, conv_in2 "
                                 f"{tuple(unet.conv_in2.weight.shape)}")
        del unet
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# --- the serving path: the HTTP server, PAB, the long video, ptp ---------------

SERVE_LATENT_CONFIG = "configs/train_mask_motion.yaml"
SERVE_SVD_CONFIG = SVD_CONFIG_PATH
# The three mask+motion requests' seeds: the first two repeat, so their gifs
# must be byte-equal now that kernels 3 and 4 add their sums in one order.
SERVE_SEEDS = (3, 3, 4)
SVD_FRAMES = 14
# Each default-path kernel's launches in one CFG forward of the full-width
# mask+motion UNet (the exact requests launch 25 times these), and the
# share of them inside the spatial (16) and temporal (17, transformer_in
# included) transformers, which PAB skips on their reuse steps: kernel 1
# runs in the 15 spatial transformers with s >= 128, kernel 2 once in every
# transformer, kernel 5 twice in every temporal one, kernel 4 in every
# transformer's proj_out (never under PAB), kernel 3 in the temporal convs.
PER_FORWARD = {"flash_attention": 15, "ln_geglu_ff": 33, "tap_conv": 88,
               "proj_residual_stats": 33, "temporal_block": 34}
SPATIAL_PER_FORWARD = {"flash_attention": 15, "ln_geglu_ff": 16}
TEMPORAL_PER_FORWARD = {"ln_geglu_ff": 17, "temporal_block": 34}
DEFAULT_PAB = {"spatial_rate": 2, "temporal_rate": 3, "warmup": 4, "tail": 1}
SVD_PAB = {"rate": 2, "warmup": 4, "tail": 1}
LONG_VIDEO_FRAMES = 27   # two 16-frame chunks, the second after an overlap of 5
# ptp's AttentionStore materialises every site's fp32 probabilities: at
# 512 px and 16 frames one top-level self-attention site alone is 34 × 5 ×
# 4096² × 4 B ≈ 11.4 GB, so the phase runs one CFG forward at 256 px and 8
# frames (18 × 5 × 1024² × 4 B ≈ 377 MB a top-level site).
PTP_RES, PTP_FRAMES = 256, 8


def exact_counts(steps: int) -> dict:
    """Kernels 1-5's launches in an exact mask+motion request."""
    return {name: steps * k for name, k in PER_FORWARD.items()}


def pab_counts(steps: int, pab: dict) -> dict:
    """Kernels 1-5's launches in a mask+motion request under ``pab``: the
    transformers' kernels on their compute steps only, kernel 4 never."""
    from animate_anything_tpu_torch.models.pab import unet3d_flags

    sflags, tflags = unet3d_flags(pab, steps)
    cs, ct = int((~sflags).sum()), int((~tflags).sum())
    got = {name: cs * SPATIAL_PER_FORWARD.get(name, 0) + ct * TEMPORAL_PER_FORWARD.get(name, 0)
           for name in PER_FORWARD}
    got["tap_conv"] = steps * PER_FORWARD["tap_conv"]
    return got


def svd_pab_counts(steps: int, pab: dict) -> dict:
    """Kernels 1, 2, 3 and 5's launches in an SVD request under ``pab``:
    kernels 1, 2 and 5 run inside the spatio-temporal transformers, on their
    compute steps; kernel 3 in the resnets, every step."""
    from animate_anything_tpu_torch.models.pab import svd_flags

    compute = int((~svd_flags(pab, steps)).sum())
    per = _svd_counts_per_request(1)
    return {name: (steps if name == "tap_conv" else compute) * k for name, k in per.items()}


def _png_b64(arr) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _http(port: int, method: str, path: str, body=None) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def serve_requests(seed: int = 0) -> tuple:
    """The server's requests: three mask+motion ones (512 px images, square
    masks, strength, prompt; ``SERVE_SEEDS``) and one SVD request (an image
    and a mask), as JSON bodies with base64 PNGs; and their arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bodies, arrays = [], []
    for i, s in enumerate(SERVE_SEEDS):
        image = rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8) if i != 1 else arrays[0][0]
        mask = np.zeros((RES, RES, 3), np.uint8)
        mask[64:320, 128:384] = 255
        arrays.append((image, mask))
        bodies.append({"workload": "latent", "image_b64": _png_b64(image),
                       "mask_b64": _png_b64(mask), "prompt": PROMPTS[0], "motion_scale": 6.0,
                       "sample_steps": STEPS, "cfg_scale": GUIDANCE, "seed": s})
    image = rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    mask = np.zeros((RES, RES, 3), np.uint8)
    mask[128:384, 128:384] = 255
    arrays.append((image, mask))
    bodies.append({"workload": "svd", "image_b64": _png_b64(image), "mask_b64": _png_b64(mask),
                   "sample_steps": STEPS, "seed": 5})
    return bodies, arrays


@contextlib.contextmanager
def _captured_latents():
    """Each mask+motion ``animate_image`` call's and SVD pipeline call's
    latents on the host and seconds (ended by a device sync), in call
    order, as (kind, latents, seconds)."""
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.pipelines.svd import MaskStableVideoDiffusionPipeline

    seen = []
    orig_l, orig_s = LatentToVideoPipeline.animate_image, MaskStableVideoDiffusionPipeline.__call__

    def recorded(kind, orig):
        def run(self, *args, **kw):
            t0 = time.perf_counter()
            video, latents = orig(self, *args, **kw)
            torch.cuda.synchronize()
            seen.append((kind, latents.float().cpu(), time.perf_counter() - t0))
            return video, latents
        return run

    latent, svd = recorded("latent", orig_l), recorded("svd", orig_s)

    LatentToVideoPipeline.animate_image, MaskStableVideoDiffusionPipeline.__call__ = latent, svd
    try:
        yield seen
    finally:
        LatentToVideoPipeline.animate_image = orig_l
        MaskStableVideoDiffusionPipeline.__call__ = orig_s


def _counted(route, jobs: list):
    """``route`` with each job's launches (counts set to 0 just before it,
    read just after) and peak memory appended to ``jobs``; it runs on the
    server's worker thread, one job at a time."""
    def run(req):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        path = route(req)
        torch.cuda.synchronize()
        jobs.append({"workload": req.get("workload", "latent"), "launches": read_counts(),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        return path
    return run


def run_server_entry(work: str) -> dict:
    """``serving.VideoServer`` over HTTP on 127.0.0.1 (an ephemeral port),
    fronting both model families (``multi_workload_generate_fn``): the
    mask+motion controller at ``SERVE_LATENT_CONFIG`` (bf16, attn_impl
    pallas, 512 px, 16 frames) and the SVD controller at
    ``SERVE_SVD_CONFIG`` (9 channels, 14 frames), random weights from the
    seed. Three mask+motion requests (25 steps, CFG 9; two with the same
    seed, whose gifs must be byte-equal) and one SVD request, all queued at
    once; every job must end ``done`` (a job's exception ends it ``error``,
    which fails the run), each launching exactly its request's counts and
    no other kernel. Logs each job's queue and generate seconds, launches
    and peak memory. → the controllers, the requests, each job's launches
    and the requests' latents."""
    import io
    import os

    from PIL import Image

    from animate_anything_tpu_torch import app, app_svd
    from animate_anything_tpu_torch.core.config import load_config
    from animate_anything_tpu_torch.serving import (VideoServer, controller_generate_fn,
                                                    multi_workload_generate_fn,
                                                    svd_controller_generate_fn)

    lcfg, scfg = load_config(SERVE_LATENT_CONFIG), load_config(SERVE_SVD_CONFIG)
    t0 = time.perf_counter()
    latent = app.AnimateController(lcfg.get("pretrained_model_path"), lcfg["validation_data"],
                                   output_dir=os.path.join(work, "latent"),
                                   attn_impl=lcfg["attn_impl"],
                                   mixed_precision=lcfg["mixed_precision"])
    t1 = time.perf_counter()
    svd = app_svd.AnimateController(None, scfg["validation_data"],
                                    output_dir=os.path.join(work, "svd"),
                                    motion_mask=bool(scfg["motion_mask"]),
                                    attn_impl=scfg["attn_impl"],
                                    mixed_precision=scfg["mixed_precision"])
    torch.cuda.synchronize()
    log(f"server: the mask+motion controller at {SERVE_LATENT_CONFIG} built in {t1 - t0:.3f} s, "
        f"the SVD one at {SERVE_SVD_CONFIG} in {time.perf_counter() - t1:.3f} s")
    jobs: list = []
    server = VideoServer(multi_workload_generate_fn({
        "latent": _counted(controller_generate_fn(latent), jobs),
        "svd": _counted(svd_controller_generate_fn(svd), jobs)}), device="cuda")
    httpd = server.serve(0, host="127.0.0.1")
    port = httpd.server_address[1]
    bodies, arrays = serve_requests()
    try:
        code, body = _http(port, "GET", "/healthz")
        if code != 200 or not json.loads(body)["ok"]:
            raise AssertionError(f"server /healthz: {code} {body[:200]!r}")
        with _captured_latents() as seen:
            t0 = time.perf_counter()
            ids = []
            for b in bodies:
                code, reply = _http(port, "POST", "/generate", b)
                if code != 202:
                    raise AssertionError(f"server /generate: {code} {reply[:200]!r}")
                ids.append(json.loads(reply)["job_id"])
            status = {}
            while len(status) < len(ids) and time.perf_counter() - t0 < 300:
                if not server._worker.is_alive():
                    raise AssertionError("server: the worker thread died")
                for i in ids:
                    if i not in status:
                        st = json.loads(_http(port, "GET", f"/jobs/{i}")[1])
                        if st["status"] in ("done", "error"):
                            status[i] = st
                time.sleep(0.05)
            wall = time.perf_counter() - t0
        failed = [status.get(i, {"job_id": i, "status": "timeout"}) for i in ids
                  if status.get(i, {}).get("status") != "done"]
        if failed:
            raise AssertionError(f"server: jobs that did not end done: {failed}")
        gifs = []
        for i in ids:
            code, data = _http(port, "GET", f"/result/{i}")
            if code != 200:
                raise AssertionError(f"server /result/{i}: {code}")
            gifs.append(data)
        health = json.loads(_http(port, "GET", "/healthz")[1])
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
    if health["jobs_done"] != len(ids) or health["queue_depth"] != 0:
        raise AssertionError(f"server /healthz after the jobs: {health}")
    for (b, st, job, data, (_, _, request)) in zip(bodies, (status[i] for i in ids), jobs, gifs,
                                                   seen):
        with Image.open(io.BytesIO(data)) as gif:
            frames = SVD_FRAMES if b["workload"] == "svd" else FRAMES
            if gif.n_frames != frames or gif.size != (RES, RES):
                raise AssertionError(f"server job {st['job_id']}: gif of {gif.n_frames} "
                                     f"frames at {gif.size}")
        want = (_svd_counts_per_request(STEPS) if b["workload"] == "svd" else exact_counts(STEPS))
        names = SVD_KERNELS if b["workload"] == "svd" else FORWARD_KERNELS
        require_only(f"server job {st['job_id']}", job["launches"], names)
        got = {n: job["launches"][n] for n in names}
        if got != want:
            raise AssertionError(f"server job {st['job_id']} ({b['workload']}): launches {got}, "
                                 f"expected {want}")
        log(f"  job {st['job_id']} ({b['workload']}, seed {b['seed']}): queue "
            f"{st['queue_seconds']:.3f} s, generate {st['generate_seconds']:.3f} s (the "
            f"request {request:.3f} s, then the gif), peak {job['peak_gib']:.2f} GiB, gif "
            f"{len(data)} bytes; launches {got}")
    if gifs[0] != gifs[1]:
        raise AssertionError("server: the two requests with the same seed returned different "
                             "gifs")
    if gifs[0] == gifs[2]:
        raise AssertionError("server: requests with different seeds returned the same gif")
    log(f"  {len(ids)} jobs done in {wall:.3f} s of wall; the two same-seed mask+motion gifs "
        f"byte-equal ({len(gifs[0])} bytes); /healthz {health}")
    return {"latent": latent, "svd": svd, "bodies": bodies, "arrays": arrays, "jobs": jobs,
            "latents": [lat for _, lat, _ in seen], "seconds": [dt for _, _, dt in seen]}


def _psnr_and_drift(got, want) -> tuple:
    """bench.py's PAB quality: latent PSNR over the exact latents' range, and
    the relative drift of the latent motion score."""
    from animate_anything_tpu_torch.metrics.motion import latent_motion_score

    mse = float((got - want).square().mean())
    peak = float(want.max() - want.min())
    psnr = 10 * math.log10(peak ** 2 / max(mse, 1e-12))
    ms_e, ms_p = float(latent_motion_score(want)[0]), float(latent_motion_score(got)[0])
    return psnr, abs(ms_p - ms_e) / max(abs(ms_e), 1e-9)


def run_pab_requests(served: dict) -> tuple:
    """A default PAB mask+motion request (``DEFAULT_PAB``) and an SVD PAB
    request (``SVD_PAB``) through the server's controllers, on the same
    inputs and seeds as the server's first exact request of each family:
    seconds, launches (asserted exactly: ``pab_counts``, ``svd_pab_counts``),
    and the latent PSNR and motion-score drift against the exact request.
    → (mask+motion launches, SVD launches)."""
    from animate_anything_tpu_torch.serving import (controller_generate_fn,
                                                    svd_controller_generate_fn)

    out = []
    for kind, controller, route, pab, want_fn, at, names in (
            ("mask+motion", served["latent"], controller_generate_fn, DEFAULT_PAB, pab_counts, 0,
             FORWARD_KERNELS),
            ("SVD", served["svd"], svd_controller_generate_fn, SVD_PAB, svd_pab_counts, -1,
             SVD_KERNELS)):
        exact, exact_s, body = served["latents"][at], served["seconds"][at], served["bodies"][at]
        controller.pipeline.pab = dict(pab)
        try:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with _captured_latents() as seen, torch.inference_mode():
                t0 = time.perf_counter()
                route(controller)(body)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            launches = read_counts()
        finally:
            controller.pipeline.pab = None
        (_, latents, request), = seen
        if not torch.isfinite(latents).all():
            raise AssertionError(f"PAB {kind} request: non-finite latents")
        require_only(f"PAB {kind} request", launches, [n for n in names
                                                       if want_fn(STEPS, pab)[n]])
        got, want = {n: launches[n] for n in names}, want_fn(STEPS, pab)
        if got != want:
            raise AssertionError(f"PAB {kind} request: launches {got}, expected {want}")
        psnr, drift = _psnr_and_drift(latents, exact)
        log(f"  PAB {kind} request ({pab}): {dt:.3f} s with the gif's write, the request "
            f"{request:.3f} s (the exact one {exact_s:.3f} s), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got} (exact); "
            f"against the exact request: latent PSNR {psnr:.2f} dB, motion-score drift "
            f"{drift:.4f}")
        out.append(launches)
    return tuple(out)


def run_long_video(served: dict) -> dict:
    """``pipelines/long_video.generate_long_video`` at full width through the
    server's mask+motion pipeline: ``LONG_VIDEO_FRAMES`` frames in two
    16-frame chunks (an overlap of 5), 25 steps, CFG 9, the first server
    request's image and mask; the video finite and of its shape, kernels 1-5
    at exactly two requests' counts. → its launches."""
    from animate_anything_tpu_torch.pipelines.long_video import generate_long_video

    image, mask = served["arrays"][0]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    video, latents = generate_long_video(
        served["latent"].pipeline, image, PROMPTS[0], total_frames=LONG_VIDEO_FRAMES,
        chunk_frames=FRAMES, mask_img=mask[..., 0], motion_strength=4.0,
        num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator("cuda").manual_seed(2))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    if tuple(video.shape) != (1, LONG_VIDEO_FRAMES, RES, RES, 3) or \
            not torch.isfinite(video).all():
        raise AssertionError(f"long video: {tuple(video.shape)}, finite "
                             f"{bool(torch.isfinite(video).all())}")
    want = {n: 2 * k for n, k in exact_counts(STEPS).items()}
    require_only("long video", launches, FORWARD_KERNELS)
    got = {n: launches[n] for n in FORWARD_KERNELS}
    if got != want:
        raise AssertionError(f"long video: launches {got}, expected {want}")
    log(f"  long video: {LONG_VIDEO_FRAMES} frames in 2 chunks of {FRAMES} in {dt:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got}")
    return launches


def run_ptp_forward(served: dict) -> dict:
    """One CFG forward of the full-width mask+motion UNet under a
    prompt-to-prompt ``AttentionStore`` at ``PTP_RES`` px and ``PTP_FRAMES``
    frames (see ``PTP_RES`` for the memory): every spatial self- and
    cross-attention site stored under its down / mid / up key, each
    probability row summing to 1, the output finite; the controlled
    attention is plain torch (kernel 1 launches none), kernels 2-5 a
    forward's counts. → its launches."""
    from animate_anything_tpu_torch.utils.ptp import (AttentionStore, aggregate_attention,
                                                      attention_control)

    unet = served["latent"].pipeline.unet
    hw = PTP_RES // 8
    gen = torch.Generator(device="cuda").manual_seed(13)
    inputs = (torch.randn(2, PTP_FRAMES, hw, hw, 4, generator=gen, device="cuda"), 500,
              torch.randn(2, 77, 1024, generator=gen, device="cuda"),
              torch.randn(2, 1, hw, hw, 4, generator=gen, device="cuda"),
              torch.ones(2, 1, hw, hw, 1, device="cuda"), torch.tensor([5.0, 5.0], device="cuda"))
    log(f"ptp: one CFG forward at {PTP_RES} px, {PTP_FRAMES} frames under an AttentionStore "
        f"(at {RES} px and {FRAMES} frames one top-level site's fp32 probabilities alone would "
        f"take 34 x 5 x 4096^2 x 4 B ~ 11.4 GB)")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    store = AttentionStore()
    t0 = time.perf_counter()
    with torch.inference_mode(), attention_control(store):
        out = unet(*inputs)
        store.between_steps()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    maps = store.get_average_attention()
    sizes = {k: len(v) for k, v in maps.items()}
    missing = [k for k in ("down_self", "down_cross", "mid_self", "mid_cross", "up_self",
                           "up_cross") if not maps[k]]
    if missing or not torch.isfinite(out).all():
        raise AssertionError(f"ptp: no maps under {missing}, finite output "
                             f"{bool(torch.isfinite(out).all())}")
    worst = max(float((m.sum(-1) - 1).abs().max()) for v in maps.values() for m in v)
    if worst > 1e-3:
        raise AssertionError(f"ptp: probability rows sum to 1 within {worst:.3g}")
    heat = aggregate_attention(store, hw, ["down", "up"], is_cross=True)
    want = {n: 0 if n == "flash_attention" else k for n, k in PER_FORWARD.items()}
    got = {n: launches[n] for n in FORWARD_KERNELS}
    require_not_launched("ptp forward", launches, [n for n in launches
                                                   if n not in FORWARD_KERNELS])
    if got != want:
        raise AssertionError(f"ptp forward: launches {got}, expected {want}")
    log(f"  {dt:.3f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; maps a key "
        f"{sizes}; rows sum to 1 within {worst:.2g}; the {hw}x{hw} cross heatmap "
        f"{tuple(heat.shape)}; launches {got}")
    del store, maps, heat, out
    return launches


# ---------------------------------------------------------------------------
# The data axis (ZeRO-sharded data parallelism), LaMa and the dataset prep
# ---------------------------------------------------------------------------

ZERO_STEPS = 3
# A full-width global-batch-2 step on 2 ranks against the one-card batch-2
# step: the loss, MSE loss and grad norm within 1e-3 relative (bf16
# activations summed in another order; read 1.8e-5, 3.4e-5 and 9.4e-5 on
# the H100 80GB HBM3 at 700 W; the grad norm is taken after the all-reduce,
# so a missing or doubled reduction moves it), and the first AdamW update of
# the checked masters: its sign equal on at least 99 % of the elements
# (u = m/(√v + ε) ≈ sign(g) at the first step; a gradient within bf16
# rounding of 0 can take either sign; read 0.9991) and its relative RMS
# within 0.2 (a flipped sign moves an element by 2·lr: a share q of flips
# gives 2·√q, 0.2 at q = 1 %).
DP_LOSS_REL = 1e-3
DP_SIGN_AGREE = 0.99
DP_UPDATE_REL_RMS = 0.2
DP_CHECKED_MASTERS = 16
# Steps timed after the first, on 2 ranks and on one card alike.
DP_TIMED_STEPS = 2
# After those steps, the 2 ranks' AdamW first moments of the checked masters
# gathered whole to rank 0 (``state_dict``, the checkpoint's gather) against
# one card's: the sum-order noise of 3 steps' bf16 gradients, held as the
# relative RMS; a slice gathered to the wrong place would read about 1.4.
DP_MOMENT_REL_RMS = 5e-2
# The 2-rank data-sharded request against the one-card batch-2 request: each
# rank denoises its row at batch 1, where the kernels and cuBLAS tile another
# M; held as the decode's relative RMS.
DP_REQUEST_REL_RMS = DECODE_REL_RMS
LAMA_FRAMES = 16
LAMA_CHUNK = 8
# LaMa frame 0 on the card against the CPU, fp32 with TF32 off on both: cuFFT
# against pocketfft and cuDNN's conv algorithms against the CPU's add in
# another order (~1e-6 relative a layer) through 18 FFC blocks and a sigmoid;
# the output is in [0, 1].
LAMA_CPU_ATOL = 1e-3


def init_world_group(work: str) -> None:
    """A one-rank NCCL process group on card 0 through a ``FileStore`` in
    ``work`` (no network): what ``torchrun --nproc_per_node 1`` would start."""
    import datetime
    import os

    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(work, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))


def run_zero_train_steps() -> dict:
    """The full-width mask+motion train step (batch 1, 16 frames, 512 px,
    ``attn_impl="pallas"``) ``ZERO_STEPS`` times without a mesh, then from
    the same weights through the ZeRO path on the one-rank NCCL group's
    ``{data: -1}`` mesh: its losses, fp32 masters and AdamW moments must be
    bit-equal, and its kernel launches equal. → the ZeRO run's launches."""
    from animate_anything_tpu_torch.core.mesh import COLLECTIVES, create_mesh
    from animate_anything_tpu_torch.train import (create_train_state, make_train_step,
                                                  mask_motion_finetune)

    mesh = create_mesh({"data": -1})
    unet, vae, text = build_models(gradient_checkpointing=True)
    for module in (vae, text):
        module.requires_grad_(False)
    config, schedule = mask_motion_finetune()
    start = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    batch = make_train_batch()

    def run(m):
        unet.load_state_dict(start)
        state = create_train_state(unet, config, mesh=m)
        step = make_train_step(schedule, config, vae=vae, text_encoder=text, mesh=m)
        gen = torch.Generator(device="cuda").manual_seed(11)
        gc.collect()
        torch.cuda.synchronize()
        reset_counts()
        COLLECTIVES.ms()
        t0 = time.perf_counter()
        metrics = [step(state, batch, gen) for _ in range(ZERO_STEPS)]
        torch.cuda.synchronize()
        return state, metrics, read_counts(), time.perf_counter() - t0, COLLECTIVES.ms()

    log(f"data axis: {ZERO_STEPS} full-width train steps (batch 1, {FRAMES} frames, {RES} px) "
        f"without a mesh, then through the ZeRO path on mesh {mesh.axes} (one-rank NCCL group)")
    plain, m_plain, n_plain, t_plain, _ = run(None)
    COLLECTIVES.on = True
    try:
        zero, m_zero, n_zero, t_zero, comm_ms = run(mesh)
    finally:
        COLLECTIVES.on = False
    log(f"  losses without a mesh {[m['loss'] for m in m_plain]}, "
        f"ZeRO {[m['loss'] for m in m_zero]}")
    log(f"  seconds: {t_plain:.3f} without a mesh, {t_zero:.3f} ZeRO ({ZERO_STEPS} steps); "
        f"collectives {comm_ms:.3f} ms by events ({comm_ms / ZERO_STEPS:.3f} ms a step)")
    log(f"  this rank's optimizer bytes: {zero.optimizer.state_bytes() / 1e9:.3f} GB (ZeRO) "
        f"against {plain.optimizer.state_bytes() / 1e9:.3f} GB; "
        f"{len(zero.optimizer.plan.chunks)} of {len(zero.masters)} arrays split")
    log(f"  launches without a mesh {n_plain}; ZeRO {n_zero}")
    if m_plain != m_zero:
        raise AssertionError(f"ZeRO step metrics differ: {m_zero} against {m_plain}")
    for name in plain.masters:
        same = torch.equal(plain.masters[name], zero.masters[name]) and all(
            torch.equal(getattr(plain.optimizer, k)[name].reshape(-1),
                        getattr(zero.optimizer, k)[name].reshape(-1))
            for k in plain.optimizer.STATE)
        if not same:
            raise AssertionError(f"ZeRO step: {name} is not bit-equal")
    if n_plain != n_zero:
        raise AssertionError(f"ZeRO step launches {n_zero} against {n_plain}")
    require_only("ZeRO train step", n_zero, TRAIN_ENTRY_KERNELS)
    log(f"  ZeRO path bit-equal to the one-device step: {len(plain.masters)} masters, "
        f"their moments and {ZERO_STEPS} losses")
    del plain, zero, start, unet, vae, text
    return n_zero


def run_zero_entry() -> dict:
    """(f) ``cli`` (``train.py``) at ``configs/train_mask_motion.yaml``'s own
    ``mesh: {data: -1}`` inside the one-rank NCCL group: batch 1, one step
    with the 8-bit AdamW and the end-of-run checkpoint, on 2 synthetic clips.
    It must take the ZeRO path (a plan over one rank), launch kernels 1-5 and
    the flash backward and no other, and write the checkpoint; → its launch
    counts."""
    import os
    import shutil
    import tempfile

    from animate_anything_tpu_torch import cli

    work = tempfile.mkdtemp(prefix="zero_entry_", dir="build")
    try:
        clips = write_clips(os.path.join(work, "clips"), n=2)
        json_path = write_dataset_json(work, clips)["video_blip"]
        argv = ["--config", TRAIN_FULL_CONFIG_PATH, f"train_data.json_path={json_path}",
                "train_batch_size=1", "max_train_steps=1", "use_8bit_adam=true",
                "save_pretrained_model=false"]
        (f, launches, run_dir, _) = _train_run(
            "(f) train.py in the one-rank group, the YAML's mesh {data: -1}, 8-bit AdamW",
            cli.cli, argv, os.path.join(work, "run"))
        plan = f["state"].optimizer.plan
        if plan is None or plan.ranks != 1:
            raise AssertionError(f"(f): not the ZeRO path (plan {plan})")
        ckpt = os.path.join(run_dir, "ckpt", "step_00000001", "train_state.pt")
        if not os.path.isfile(ckpt):
            raise AssertionError(f"(f): no checkpoint at {ckpt}")
        log(f"  (f): ZeRO plan over {plan.ranks} rank, {len(plan.chunks)} of "
            f"{len(f['state'].masters)} arrays split; checkpoint "
            f"{os.path.getsize(ckpt) / 1e9:.3f} GB")
        require_only("(f) train.py in the group", launches, TRAIN_ENTRY_KERNELS)
        del f
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def _dp_batch() -> dict:
    """A global batch of two clips (``make_train_batch`` seeds 0 and 1)."""
    a, b = make_train_batch(0), make_train_batch(1)
    return {k: torch.cat([a[k], b[k]]) for k in a}


def _dp_request_inputs(pipe, seed: int = 31) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.randn((2, 1, RES // 8, RES // 8, 4), generator=gen, device="cuda")
    ts = pipe.get_timesteps(STEPS)
    embeds, negative = pipe.encode_prompt(list(PROMPTS))
    return dict(latents=pipe.prepare_init_latents(img, FRAMES, ts, gen),
                condition_latent=img, prompt_embeds=embeds,
                negative_prompt_embeds=negative,
                mask=torch.ones((2, 1, RES // 8, RES // 8, 1), device="cuda"),
                motion=[3.0, 5.0], timesteps=ts, guidance_scale=GUIDANCE)


def _dp_step_and_request(mesh, out_path: Optional[str] = None) -> dict:
    """The full-width global-batch-2 step and a batch-2 request with ``mesh``
    (this rank's rows) or without it; → the first step's metrics and
    updates of ``DP_CHECKED_MASTERS`` masters (fp32, host), the seconds a
    step and the collectives' milliseconds a step over ``DP_TIMED_STEPS``
    more steps, those masters' first moments from the optimizer's
    ``state_dict`` (gathered to rank 0; None on the other rank) and its
    seconds, and the video (host)."""
    from animate_anything_tpu_torch.core.mesh import COLLECTIVES, shard_batch
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.train import (create_train_state, make_train_step,
                                                  mask_motion_finetune)

    unet, vae, text = build_models(gradient_checkpointing=True)
    for module in (vae, text):
        module.requires_grad_(False)
    config, schedule = mask_motion_finetune()
    state = create_train_state(unet, config, mesh=mesh)
    names = sorted(state.masters, key=lambda n: -state.masters[n].numel())[:DP_CHECKED_MASTERS]
    before = {n: state.masters[n].clone() for n in names}
    step = make_train_step(schedule, config, vae=vae, text_encoder=text, mesh=mesh)
    batch = _dp_batch() if mesh is None else shard_batch(_dp_batch(), mesh)
    gen = torch.Generator(device="cuda").manual_seed(11)
    metrics = step(state, batch, gen)
    update = {n: (state.masters[n] - before[n]).to("cpu") for n in names}
    del before
    torch.cuda.synchronize()
    COLLECTIVES.on = True
    try:
        COLLECTIVES.ms()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            step(state, batch, gen)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / DP_TIMED_STEPS
        comm_ms = COLLECTIVES.ms() / DP_TIMED_STEPS
    finally:
        COLLECTIVES.on = False
    t0 = time.perf_counter()
    whole = state.optimizer.state_dict()      # a collective under the mesh
    gather_s = time.perf_counter() - t0
    moments = None if whole is None else {n: whole["mu"][n].to("cpu", copy=True) for n in names}
    del state, step, whole
    gc.collect()
    torch.cuda.empty_cache()
    pipe = LatentToVideoPipeline(unet.eval(), vae, text_encoder=text,
                                 tokenizer=HashTokenizer(), mesh=mesh)
    t0 = time.perf_counter()
    video, _ = pipe(**_dp_request_inputs(pipe))
    torch.cuda.synchronize()
    out = {"metrics": metrics, "update": update, "step_s": step_s, "comm_ms": comm_ms,
           "moments": moments, "gather_s": gather_s,
           "video": video.float().cpu(), "request_s": time.perf_counter() - t0}
    if out_path is not None:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            torch.save(out, out_path)
    return out


def _dp_rank(out_path: str) -> None:
    """One rank of the 2-card phase (``spawn_ranks`` target)."""
    from animate_anything_tpu_torch.core.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _dp_step_and_request(create_mesh({"data": -1}), out_path)


def run_multi_gpu() -> list:
    """Where two or more cards exist: 2 NCCL ranks run the global-batch-2
    step and a data-sharded batch-2 request against the one-card batch-2
    step and request, then ``dryrun_multichip(2)``; → which of these ran."""
    import os
    import tempfile

    from animate_anything_tpu_torch.dryrun import dryrun_multichip, spawn_ranks

    n = torch.cuda.device_count()
    if n < 2:
        log(f"multi-card phase: {n} card, skipped (the 2-rank step, the sharded request and "
            "dryrun_multichip(2) need 2)")
        return []
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dp_", dir="build") as work:
        out = os.path.join(work, "rank0.pt")
        t0 = time.perf_counter()
        spawn_ranks("chip_smoke:_dp_rank", 2, "cuda", out, timeout=600)
        log(f"2 NCCL ranks: step and sharded request in {time.perf_counter() - t0:.1f} s")
        got = torch.load(out, weights_only=False)
    want = _dp_step_and_request(None)
    for k in ("loss", "mse_loss", "grad_norm"):
        rel = abs(got["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-12)
        log(f"  {k}: 2 ranks {got['metrics'][k]:.6g}, one card {want['metrics'][k]:.6g} "
            f"(relative {rel:.3g}, limit {DP_LOSS_REL})")
        if not rel <= DP_LOSS_REL:
            raise AssertionError(f"2-rank step {k} off by {rel:.3g}")
    agree = sum(int((got["update"][n].sign() == want["update"][n].sign()).sum())
                for n in want["update"])
    total = sum(t.numel() for t in want["update"].values())
    diff = sum(float((got["update"][n].double() - want["update"][n].double()).square().sum())
               for n in want["update"])
    norm = sum(float(want["update"][n].double().square().sum()) for n in want["update"])
    update_rel = (diff / norm) ** 0.5
    log(f"  first update, {total} elements of {len(want['update'])} masters: sign equal on "
        f"{agree / total:.6f} (limit {DP_SIGN_AGREE}), relative RMS {update_rel:.4g} "
        f"(limit {DP_UPDATE_REL_RMS})")
    if agree / total < DP_SIGN_AGREE:
        raise AssertionError(f"2-rank step: update signs agree on {agree / total:.4f}")
    if not update_rel <= DP_UPDATE_REL_RMS:
        raise AssertionError(f"2-rank step: first update's relative RMS {update_rel:.4g}")
    diff = sum(float((got["moments"][n].double() - want["moments"][n].double()).square().sum())
               for n in want["moments"])
    norm = sum(float(want["moments"][n].double().square().sum()) for n in want["moments"])
    moment_rel = (diff / norm) ** 0.5
    log(f"  AdamW first moments after {1 + DP_TIMED_STEPS} steps, gathered whole to rank 0 "
        f"in {got['gather_s']:.3f} s (state_dict; one card's {want['gather_s']:.3f} s): "
        f"relative RMS {moment_rel:.4g} (limit {DP_MOMENT_REL_RMS})")
    if not moment_rel <= DP_MOMENT_REL_RMS:
        raise AssertionError(f"2-rank state_dict: moments' relative RMS {moment_rel:.4g}")
    log(f"  global batch 2, s/step over {DP_TIMED_STEPS} steps after the first: "
        f"{got['step_s']:.3f} on 2 ranks (collectives {got['comm_ms']:.1f} ms a step on rank "
        f"0), {want['step_s']:.3f} on one card")
    rel = _rel_rms(got["video"], want["video"])
    log(f"  sharded request ({got['request_s']:.3f} s on 2 ranks, {want['request_s']:.3f} s on "
        f"one card): video relative RMS {rel:.4g} (limit {DP_REQUEST_REL_RMS})")
    if not rel <= DP_REQUEST_REL_RMS:
        raise AssertionError(f"2-rank sharded request: relative RMS {rel:.4g}")
    del want, got
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result = dryrun_multichip(2)
    log(f"  dryrun_multichip(2): {result} in {time.perf_counter() - t0:.1f} s")
    return ["2-rank step", "2-rank sharded request", "dryrun_multichip(2)"]


# -- the frame and tensor axes ---------------------------------------------
# The frame-2 request (16 frames: 9 + 8 of the UNet's 17 on the two ranks,
# every temporal layer between two all-to-alls, its GroupNorm sums summed
# over the pair) and the {frame: 2, tensor: 2} request against the one-card
# request on the same seed (the start noise drawn whole on every rank): bf16
# activations go through other tile shapes at half the positions or heads
# and the sums add in another order; held as the decode's relative RMS.
FRAME_REQUEST_REL_RMS = DECODE_REL_RMS
# The tensor-2 full-width batch-1 step against the one-card step: the data
# axis's limits (the row-parallel products' bf16 partials summed in fp32).
TP_LOSS_REL, TP_SIGN_AGREE, TP_UPDATE_REL_RMS = DP_LOSS_REL, DP_SIGN_AGREE, DP_UPDATE_REL_RMS
FRAME_PATH_KERNELS = FORWARD_KERNELS + ("tap_conv.positions",)
TENSOR_PATH_KERNELS = FORWARD_KERNELS + ("ln_geglu_ff.partial", "temporal_block.heads")


def _axes_request(mesh, out_path: Optional[str] = None) -> dict:
    """The full-width default request (``make_requests()[0]``: 16 frames,
    512 px, 25 DPM-Solver++ steps, CFG 9, ``attn_impl="pallas"``, the VAE
    decode) under ``mesh`` (its tensor axis splitting the UNet) or on one
    card, twice on the same seed; → the video (host), both walls, whether
    the two videos are bit-equal, the launches of the first, the frame and
    tensor axes' collectives a CFG forward, the peak memory."""
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.parallel import frame, tensor
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    unet, vae, text = build_models()
    tensor.shard_model(unet, mesh)
    pipe = LatentToVideoPipeline(unet, vae, text_encoder=text, tokenizer=HashTokenizer(),
                                 mesh=mesh)
    req = make_requests()[0]
    videos, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        gen = torch.Generator(device="cuda").manual_seed(7)
        if i == 0:
            reset_counts()
            frame.COLLECTIVES.on = tensor.COLLECTIVES.on = True
            frame.COLLECTIVES.ms(), tensor.COLLECTIVES.ms()
        t0 = time.perf_counter()
        video, _ = pipe.animate_image(num_frames=FRAMES, num_inference_steps=STEPS,
                                      guidance_scale=GUIDANCE, generator=gen, **req)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            counts = read_counts()
            comm = (frame.COLLECTIVES.ms() / STEPS, tensor.COLLECTIVES.ms() / STEPS)
            frame.COLLECTIVES.on = tensor.COLLECTIVES.on = False
        if tuple(video.shape) != (1, FRAMES, RES, RES, 3) or not torch.isfinite(video).all():
            raise AssertionError(f"axes request: video {tuple(video.shape)}, or not finite")
        videos.append(video.float().cpu())
    out = {"video": videos[0], "walls": walls, "same": torch.equal(videos[0], videos[1]),
           "counts": counts, "frame_ms": comm[0], "tensor_ms": comm[1],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if out_path is not None:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            torch.save(out, out_path)
    return out


def _axes_step(mesh, out_path: Optional[str] = None) -> dict:
    """The full-width batch-1 train step (``make_train_batch``, per-sub-layer
    checkpointing, AdamW on fp32 masters) with the UNet split over ``mesh``'s
    tensor axis, or on one card; → the first step's metrics, the first
    update of ``DP_CHECKED_MASTERS`` masters whole (gathered to rank 0),
    s/step over ``DP_TIMED_STEPS`` more steps, the tensor axis's collectives
    a step, the peak memory and the launches of the timed steps."""
    from animate_anything_tpu_torch.parallel import tensor
    from animate_anything_tpu_torch.train import (create_train_state, make_train_step,
                                                  mask_motion_finetune)

    unet, vae, text = build_models(gradient_checkpointing=True)
    for module in (vae, text):
        module.requires_grad_(False)
    names = sorted((n for n, _ in unet.named_parameters()),
                   key=lambda n: -unet.get_parameter(n).numel())[:DP_CHECKED_MASTERS]
    tensor.shard_model(unet, mesh)
    config, schedule = mask_motion_finetune()
    state = create_train_state(unet, config, mesh=mesh)
    before = {n: state.masters[n].clone() for n in names}
    step = make_train_step(schedule, config, vae=vae, text_encoder=text, mesh=mesh)
    batch = make_train_batch()
    gen = torch.Generator(device="cuda").manual_seed(11)
    metrics = step(state, batch, gen)
    update = tensor.full_weights(unet, {n: state.masters[n] - before[n] for n in names})
    update = None if update is None else {n: t.to("cpu") for n, t in update.items()}
    del before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tensor.COLLECTIVES.on = True
    try:
        tensor.COLLECTIVES.ms()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            step(state, batch, gen)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / DP_TIMED_STEPS
        comm_ms = tensor.COLLECTIVES.ms() / DP_TIMED_STEPS
    finally:
        tensor.COLLECTIVES.on = False
    out = {"metrics": metrics, "update": update, "step_s": step_s, "comm_ms": comm_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "counts": read_counts()}
    if out_path is not None:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            torch.save(out, out_path)
    return out


AXES_MESHES = {"frame2": {"data": 1, "frame": 2}, "tensor2": {"data": 1, "tensor": 2},
               "frame2_tensor2": {"data": 1, "frame": 2, "tensor": 2}}


def _axes_rank(kind: str, out_path: str) -> None:
    """One rank of a multi-card axes phase (``spawn_ranks`` target)."""
    from animate_anything_tpu_torch.core.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(AXES_MESHES[kind])
    (_axes_step if kind == "tensor2" else _axes_request)(mesh, out_path)


def run_axes_one_rank() -> dict:
    """Inside the one-rank NCCL group: the full-width default request on a
    ``{data: 1, frame: 1, tensor: 1}`` mesh (the frame path with its
    all-to-alls, sums reductions and gather over one rank; the tensor axis
    of 1 splits nothing, as JAX's rule) against the same request without a
    mesh: the videos bit-equal. → the mesh request's launches."""
    from animate_anything_tpu_torch.core.mesh import create_mesh

    mesh = create_mesh({"data": 1, "frame": 1, "tensor": 1})
    log(f"frame and tensor axes: the default request on mesh {mesh.axes} (one-rank NCCL "
        "group) against the same request without a mesh")
    plain = _axes_request(None)
    gc.collect()
    torch.cuda.empty_cache()
    split = _axes_request(mesh)
    log(f"  walls: {plain['walls'][0]:.3f} s without a mesh, {split['walls'][0]:.3f} s on the "
        f"mesh (all-to-alls and sums {split['frame_ms']:.3f} ms a CFG forward by events)")
    if not torch.equal(plain["video"], split["video"]):
        raise AssertionError(f"one-rank mesh request differs: relative RMS "
                             f"{_rel_rms(split['video'], plain['video']):.3g}")
    require_only("one-rank mesh request", split["counts"], FRAME_PATH_KERNELS)
    log(f"  bit-equal; launches {split['counts']}")
    return split["counts"]


def _axes_spawn(kind: str, ranks: int) -> dict:
    import os
    import tempfile

    from animate_anything_tpu_torch.dryrun import spawn_ranks

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="axes_", dir="build") as work:
        out = os.path.join(work, "rank0.pt")
        t0 = time.perf_counter()
        spawn_ranks("chip_smoke:_axes_rank", ranks, "cuda", kind, out, timeout=900)
        log(f"{ranks} NCCL ranks, mesh {AXES_MESHES[kind]}: {time.perf_counter() - t0:.1f} s "
            "with the model build")
        return torch.load(out, weights_only=False)


def _check_axes_request(tag: str, got: dict, want: dict) -> None:
    rel = _rel_rms(got["video"], want["video"])
    log(f"  {tag} request: video relative RMS {rel:.4g} against one card (limit "
        f"{FRAME_REQUEST_REL_RMS}); wall {got['walls'][0]:.3f} s (again {got['walls'][1]:.3f} s) "
        f"against {want['walls'][0]:.3f} s on one card; frame-axis collectives "
        f"{got['frame_ms']:.3f} ms and tensor-axis {got['tensor_ms']:.3f} ms a CFG forward on "
        f"rank 0 (events); peak {got['peak_gib']:.2f} GiB on rank 0, {want['peak_gib']:.2f} "
        f"on one card; two same-seed requests bit-equal: {got['same']}")
    if not rel <= FRAME_REQUEST_REL_RMS:
        raise AssertionError(f"{tag} request: relative RMS {rel:.4g}")
    if not got["same"]:
        raise AssertionError(f"{tag} request: two same-seed requests differ")


def run_axes_multi_gpu() -> dict:
    """Where two or more cards exist: the frame-2 request and the tensor-2
    step against one card; with four, the {frame: 2, tensor: 2} request and
    ``dryrun_multichip(4)``; with eight, ``dryrun_multichip(8)``. → each
    phase's launch counts on rank 0."""
    from animate_anything_tpu_torch.dryrun import dryrun_multichip

    n = torch.cuda.device_count()
    if n < 2:
        log(f"frame and tensor axes, multi-card phases: {n} card, skipped (the frame-2 request "
            "and the tensor-2 step need 2 cards, the {frame: 2, tensor: 2} request and "
            "dryrun_multichip(4) 4, dryrun_multichip(8) 8)")
        return {}
    counts = {}
    frame2 = _axes_spawn("frame2", 2)
    step2 = _axes_spawn("tensor2", 2)
    both = _axes_spawn("frame2_tensor2", 4) if n >= 4 else None
    want = _axes_request(None)
    _check_axes_request("frame 2", frame2, want)
    require_only("frame-2 request", frame2["counts"], FRAME_PATH_KERNELS)
    counts["frame2"] = frame2["counts"]
    if both is not None:
        _check_axes_request("{frame: 2, tensor: 2}", both, want)
        require_only("{frame: 2, tensor: 2} request", both["counts"],
                     FRAME_PATH_KERNELS + TENSOR_PATH_KERNELS[len(FORWARD_KERNELS):])
        counts["frame2_tensor2"] = both["counts"]
    del want, frame2, both
    gc.collect()
    torch.cuda.empty_cache()
    want = _axes_step(None)
    for k in ("loss", "mse_loss", "grad_norm"):
        rel = abs(step2["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-12)
        log(f"  tensor 2 step {k}: {step2['metrics'][k]:.6g} against {want['metrics'][k]:.6g} "
            f"on one card (relative {rel:.3g}, limit {TP_LOSS_REL})")
        if not rel <= TP_LOSS_REL:
            raise AssertionError(f"tensor-2 step {k} off by {rel:.3g}")
    got_u, want_u = step2["update"], want["update"]
    agree = sum(int((got_u[k].sign() == want_u[k].sign()).sum()) for k in want_u)
    total = sum(t.numel() for t in want_u.values())
    diff = sum(float((got_u[k].double() - want_u[k].double()).square().sum()) for k in want_u)
    norm = sum(float(want_u[k].double().square().sum()) for k in want_u)
    update_rel = (diff / norm) ** 0.5
    log(f"  tensor 2 first update, {total} elements of {len(want_u)} masters gathered whole: "
        f"sign equal on {agree / total:.6f} (limit {TP_SIGN_AGREE}), relative RMS "
        f"{update_rel:.4g} (limit {TP_UPDATE_REL_RMS})")
    if agree / total < TP_SIGN_AGREE or not update_rel <= TP_UPDATE_REL_RMS:
        raise AssertionError(f"tensor-2 step: first update off ({agree / total:.4f}, "
                             f"{update_rel:.4g})")
    log(f"  tensor 2 step: {step2['step_s']:.3f} s/step (tensor-axis collectives "
        f"{step2['comm_ms']:.1f} ms a step on rank 0), peak {step2['peak_gib']:.2f} GiB on rank "
        f"0; one card {want['step_s']:.3f} s/step, peak {want['peak_gib']:.2f} GiB")
    require_only("tensor-2 step", step2["counts"],
                 TENSOR_PATH_KERNELS + ("flash_attention_bwd",))
    counts["tensor2"] = step2["counts"]
    del want, step2
    gc.collect()
    torch.cuda.empty_cache()
    for ranks in (4, 8):
        if n >= ranks:
            t0 = time.perf_counter()
            result = dryrun_multichip(ranks)
            log(f"  dryrun_multichip({ranks}): {result} in {time.perf_counter() - t0:.1f} s")
    return counts


def fill_mode_launches(rows: list[dict], paths: dict) -> None:
    """Each kernel mode's launches: its counter on every path that ran it
    (``launches_<path>``); ``launches`` the first of the one-rank mesh
    request, the frame-2 request and the tensor-2 step that ran it."""
    for row in rows:
        for mode in row.get("modes", {}).values():
            counter = mode["counter"]
            for label, counts in paths.items():
                mode[f"launches_{label}"] = counts.get(counter, 0)
            mode["launches"] = next((counts[counter] for counts in paths.values()
                                     if counts.get(counter, 0)), 0)


def _lama_video(seed: int = 21):
    """A 16-frame 512 px clip: a smooth random image drifting 8 px a frame,
    and a rectangular watermark mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.random((RES // 32, RES // 32, 3)).astype(np.float32)
    base = np.kron(coarse, np.ones((32, 32, 1), np.float32))
    video = np.stack([np.roll(base, 8 * i, axis=1) for i in range(LAMA_FRAMES)])
    video = (video * 255).astype(np.uint8)
    mask = np.zeros((RES, RES), np.uint8)
    mask[RES * 5 // 16:RES * 11 // 16, RES * 3 // 16:RES * 13 // 16] = 255
    return video, mask


def run_lama() -> dict:
    """LaMa at full width (``LamaConfig()``, seeded weights, randomized
    BatchNorm statistics) on a 16-frame 512 px clip through ``inpaint_video``
    on the card: unmasked pixels exact, frame 0 against the same module on
    the CPU within ``LAMA_CPU_ATOL``; then the CLI on a gif and a mask PNG
    with a ``best.ckpt``-layout file, its output equal to
    ``inpaint_video``'s."""
    import os
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from animate_anything_tpu_torch.models import lama
    from animate_anything_tpu_torch.utils import media
    from animate_anything_tpu_torch.utils.convert import init_lama_

    with torch.device("cuda"):
        module = lama.LargeMaskInpainting()
    init_lama_(module, torch.Generator(device="cuda").manual_seed(21)).eval()
    n_params = sum(p.numel() for p in module.parameters())
    video, mask = _lama_video()
    lama.inpaint_video(video[:LAMA_CHUNK], mask, module, chunk=LAMA_CHUNK)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = lama.inpaint_video(video, mask, module, chunk=LAMA_CHUNK)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"LaMa (big-lama, {n_params / 1e6:.1f} M params, fp32): {LAMA_FRAMES} frames at "
        f"{RES}x{RES} in {dt:.3f} s ({LAMA_FRAMES / dt:.2f} frames/s, chunk {LAMA_CHUNK}), "
        f"peak {peak:.2f} GiB")
    outside = mask < 128
    if out.shape != video.shape or out.dtype != np.uint8:
        raise AssertionError(f"LaMa: output {out.shape} {out.dtype}")
    if not np.array_equal(out[:, outside], video[:, outside]):
        raise AssertionError("LaMa: pixels outside the mask changed")
    changed = float((out[:, ~outside] != video[:, ~outside]).mean())
    log(f"  pixels outside the mask equal the input; {changed:.3f} of those inside changed")
    if changed == 0.0:
        raise AssertionError("LaMa: nothing inside the mask changed")

    m = torch.as_tensor((mask / 255.0 >= 0.5).astype(np.float32))[None, None]
    img = torch.as_tensor(video[:1]).float().div(255.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        card = module(img.cuda(), m.cuda()).cpu()
        cpu = copy.deepcopy(module).cpu()(img, m)
    err = float((card - cpu).abs().max())
    log(f"  frame 0, card against CPU (fp32, TF32 off): max |diff| {err:.3g} "
        f"(limit {LAMA_CPU_ATOL})")
    if not err <= LAMA_CPU_ATOL:
        raise AssertionError(f"LaMa frame 0: card against CPU {err:.3g}")

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="lama_", dir="build")
    try:
        gif = media.save_gif(os.path.join(work, "clip.gif"), video, fps=8)
        Image.fromarray(mask).save(os.path.join(work, "mask.png"))
        ckpt = os.path.join(work, "best.ckpt")
        torch.save({"state_dict": {f"generator.{k}": v.cpu()
                                   for k, v in module.state_dict().items()}}, ckpt)
        frames = media.load_video_frames(gif)
        again = [lama.inpaint_video(frames, mask, module) for _ in range(2)]
        differ = int((again[0] != again[1]).any(-1).sum())
        log(f"  two inpaint_video calls on the same frames (cuDNN's default algorithms): "
            f"{differ} pixels differ, max {int(np.abs(again[0].astype(int) - again[1]).max())} "
            "level")
        # the CLI's output against inpaint_video's, bit for bit: cuDNN's
        # deterministic algorithms for both
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            t0 = time.perf_counter()
            written = lama._main([gif, os.path.join(work, "mask.png"), ckpt,
                                  "--out", os.path.join(work, "clip_inpainted.gif")])
            cli_s = time.perf_counter() - t0
            want = media.save_gif(os.path.join(work, "want.gif"),
                                  lama.inpaint_video(frames, mask, module), fps=8)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        with open(written, "rb") as a, open(want, "rb") as b:
            if a.read() != b.read():
                raise AssertionError("LaMa CLI: its gif differs from inpaint_video's")
        log(f"  CLI (best.ckpt layout, strict load, gif in and out): {cli_s:.3f} s, its gif "
            "byte-equal to inpaint_video's (cuDNN deterministic for both)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"seconds": dt, "frames_per_s": LAMA_FRAMES / dt, "peak_gib": peak,
            "cpu_err": err, "cli_s": cli_s}


def run_compress_video() -> None:
    """``compress_video frames`` and ``folder_json`` on a generated gif; the
    shard read back through ``VideoReader`` bit-equal to the gif's frames."""
    import json as _json
    import os
    import shutil
    import tempfile

    import numpy as np

    from animate_anything_tpu_torch import compress_video
    from animate_anything_tpu_torch.data.video_io import VideoReader
    from animate_anything_tpu_torch.utils import media

    work = tempfile.mkdtemp(prefix="prep_", dir="build")
    try:
        video, _ = _lama_video(seed=22)
        os.makedirs(os.path.join(work, "in"))
        gif = media.save_gif(os.path.join(work, "in", "clip.gif"), video[:8, ::2, ::2], fps=8)
        with open(os.path.join(work, "in", "clip.txt"), "w") as f:
            f.write("a drifting pattern\n")
        t0 = time.perf_counter()
        compress_video.frames(os.path.join(work, "in"), os.path.join(work, "shards"))
        compress_video.folder_json(os.path.join(work, "in"), os.path.join(work, "data.json"))
        dt = time.perf_counter() - t0
        vr = VideoReader(os.path.join(work, "shards", "clip"))
        back = vr.get_batch(range(len(vr)))
        if not np.array_equal(back, media.load_video_frames(gif)):
            raise AssertionError("compress_video frames: the shard differs from the gif")
        with open(os.path.join(work, "data.json")) as f:
            items = _json.load(f)
        if items != [{"video": gif, "caption": "a drifting pattern"}]:
            raise AssertionError(f"compress_video folder_json: {items}")
        log(f"compress_video: frames + folder_json on an 8-frame gif in {dt:.3f} s; the shard "
            f"({len(vr)} PNGs, fps {vr.fps}) bit-equal to the gif's frames")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_serving_paths() -> dict:
    """The server, then PAB, the long video and ptp on the server's models;
    → each path's launches."""
    import os
    import shutil
    import tempfile

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="serve_", dir="build")
    try:
        served = run_server_entry(work)
        pab_latent, pab_svd = run_pab_requests(served)
        long_video = run_long_video(served)
        ptp = run_ptp_forward(served)
        jobs = served["jobs"]
        del served
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"server": jobs[0]["launches"], "server_svd": jobs[-1]["launches"],
            "pab": pab_latent, "pab_svd": pab_svd, "long_video": long_video, "ptp": ptp}


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
    check_sites(torch.Generator(device="cuda").manual_seed(4), rows, "svd", svd_sites())
    check_sites(torch.Generator(device="cuda").manual_seed(6), rows, "stage2", stage2_sites())
    check_attention_gates(torch.Generator(device="cuda").manual_seed(5))
    entry = run_entry_points()
    log("temporal transformers, fused vs composite path (bf16, b=2, f=17):")
    time_temporal_paths()
    check_small_unet()
    check_small_unet(attn_impl="packed")
    check_small_unet_grads()
    check_small_svd_unet()
    check_svd_site_grads(torch.Generator(device="cuda").manual_seed(7), rows)
    check_svd_checkpointing()

    pipe = build_pipeline()
    requests = run_requests(pipe)
    opt_in = run_opt_in_request(pipe)
    packed = run_packed_request(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    evaluation = run_eval_entry()
    gc.collect()
    torch.cuda.empty_cache()
    svd = run_svd_entry()
    gc.collect()
    torch.cuda.empty_cache()
    stage2 = run_stage2_entry()
    gc.collect()
    torch.cuda.empty_cache()
    serving = run_serving_paths()
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train_steps()
    gc.collect()
    torch.cuda.empty_cache()
    train_entry = run_train_entry()
    gc.collect()
    torch.cuda.empty_cache()
    svd_train = run_svd_train_entry()
    gc.collect()
    torch.cuda.empty_cache()
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    os.makedirs("build", exist_ok=True)
    store = tempfile.mkdtemp(prefix="group_", dir="build")
    t_new = time.perf_counter()
    init_world_group(store)
    zero = run_zero_train_steps()
    gc.collect()
    torch.cuda.empty_cache()
    zero_entry = run_zero_entry()
    gc.collect()
    torch.cuda.empty_cache()
    axes_one = run_axes_one_rank()
    dist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)
    t_new = time.perf_counter() - t_new
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_lama()
    gc.collect()
    torch.cuda.empty_cache()
    run_compress_video()
    t_new += time.perf_counter() - t0
    log(f"the data axis, LaMa and compress_video phases took {t_new:.1f} s")
    multi = run_multi_gpu()
    log(f"multi-card phases run: {multi or 'none (one card)'}")
    axes_multi = run_axes_multi_gpu()
    fill_mode_launches(rows, {"mesh_one_rank": axes_one, **axes_multi})
    for row in rows:
        for mode, m in row.get("modes", {}).items():
            if m["launches"] == 0 and not (mode != "positions" and not axes_multi):
                raise AssertionError(f"{row['name']}.{mode}: launched on no path")
    own_path = {"flash_attention_bwd": train, **{n: opt_in for n in OPT_IN_KERNELS},
                **{n: packed for n in PACKED_KERNELS}, **{n: entry for n in ENTRY_KERNELS}}
    for row in rows:
        name = row["name"]
        counter = ROW_COUNTER.get(name, name)
        row["launches"] = own_path.get(name, requests)[name]
        for label, counts in (("requests", requests), ("opt_in", opt_in), ("packed", packed),
                              ("entry_points", entry), ("eval", evaluation), ("svd", svd),
                              ("train", train),
                              ("train_entry", train_entry["lora"]),
                              ("train_full", train_entry["full"]), ("stage2", stage2),
                              ("svd_train", svd_train), ("zero", zero),
                              ("zero_entry", zero_entry), *serving.items()):
            row[f"launches_{label}"] = counts.get(name, counts[counter])

    print(json.dumps({"kernels": rows}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
