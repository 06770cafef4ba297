"""``svd_img2vid_mask``: the port's masked SVD pipeline
(``pipelines/svd.py::MaskStableVideoDiffusionPipeline``) over the
spatio-temporal UNet with the mask channel, the SD VAE and the CLIP image
tower, and the plain reference over the same drawn weights. The loop's
interface is ``animate_anything_512.System``'s."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import weights as W
from perfbench.harness.system import PortSystem
from perfbench.harness.system import cast as cast_all
from perfbench.harness.traffic import rect_mask
from perfbench.reference.latent2video import latent_mask
from perfbench.reference.numerics import Numerics, strict_fp32
from perfbench.reference.svd import Request, check

COMPONENTS = ("unet", "vae", "image_encoder")


class System(PortSystem):
    COMPONENTS = COMPONENTS

    def port_modules(self, cast: bool = True) -> dict:
        from animate_anything_tpu_torch.models.clip_vision import (
            CLIPVisionConfig, CLIPVisionModelWithProjection)
        from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                                UNetSpatioTemporalConditionModel)
        from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig

        cfg = self.cfg
        u = dict(cfg["unet"])
        for k in ("block_out_channels", "num_attention_heads"):
            u[k] = tuple(u[k])
        v = dict(cfg["vae"])
        v["block_out_channels"] = tuple(v["block_out_channels"])
        i = cfg["image_encoder"]
        with torch.device("meta"):
            mods = {"unet": UNetSpatioTemporalConditionModel(SVDUNetConfig(**u)),
                    "vae": AutoencoderKL(VAEConfig(**v)),
                    "image_encoder": CLIPVisionModelWithProjection(CLIPVisionConfig(
                        hidden_size=i["hidden_size"], num_layers=i["num_hidden_layers"],
                        num_heads=i["num_attention_heads"],
                        intermediate_size=i["intermediate_size"], image_size=i["image_size"],
                        patch_size=i["patch_size"], projection_dim=i["projection_dim"],
                        hidden_act=i["hidden_act"]))}
        return cast_all(mods) if cast else mods

    def build_program(self, weights: dict):
        from animate_anything_tpu_torch.pipelines.svd import MaskStableVideoDiffusionPipeline

        mods = self.load(weights)
        return MaskStableVideoDiffusionPipeline(mods["unet"], mods["vae"],
                                                image_encoder=mods["image_encoder"])

    def make_request(self, traffic: dict, seed: int, index: int) -> dict:
        """Request ``index`` of the seed: an image, a mask rectangle of
        ``mask_area`` of it snapped to the latent grid, the start noise and
        the image's augmentation noise. Every request has the same sizes."""
        rng = np.random.default_rng([int(seed) % 2**63, index + 1])
        res, frames = traffic["resolution"], traffic["frames"]
        image = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
        mask_img = rect_mask(rng, res, traffic["mask_area"])
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(2**62)))
        noise = torch.randn((1, frames, res // 8, res // 8, 4), generator=gen, device=self.device)
        aug = torch.randn((1, 1, res, res, 3), generator=gen, device=self.device)
        keys = ("frames", "steps", "min_guidance", "max_guidance", "fps", "motion_bucket",
                "noise_aug", "decode_chunk")
        return dict(image=image, mask=latent_mask(mask_img, res // 8, res // 8, self.device),
                    noise=noise, aug_noise=aug, **{k: traffic[k] for k in keys})

    def run_request(self, program, req: dict):
        return program(req["image"], mask=req["mask"], num_frames=req["frames"],
                       num_inference_steps=req["steps"], min_guidance_scale=req["min_guidance"],
                       max_guidance_scale=req["max_guidance"], fps=req["fps"],
                       motion_bucket_id=req["motion_bucket"],
                       noise_aug_strength=req["noise_aug"],
                       decode_chunk_size=req["decode_chunk"], noise=req["noise"],
                       aug_noise=req["aug_noise"])

    def capture(self, program) -> "Capture":
        return Capture(program.unet)

    def span_targets(self, program) -> list:
        import animate_anything_tpu_torch.pipelines.svd as svd

        return [("unet", program.unet), ("vae_decode", svd, "decode_video")]

    def reference(self, weights: dict, numerics: str = "fp32") -> Request:
        strict_fp32()
        return Request({c: W.as_fp32(weights[c]) for c in COMPONENTS}, self.cfg,
                       Numerics(numerics))

    def check(self, ref: Request, req: dict, rec: dict, checks: dict) -> dict:
        return check(ref, req, rec, checks["unet_steps"], self.device)

    def request_flops(self, traffic: dict) -> float:
        """The FLOP of one request over the reference's flow on the meta
        device (products only): the encodes, one CFG forward times the
        steps, the decode."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = self.meta_weights()
        ref = Request(meta, self.cfg, Numerics("fp32"))
        req = self.make_request(traffic, 0, 0)
        for k in ("noise", "aug_noise", "mask"):
            req[k] = torch.empty(req[k].shape, device="meta")
        with FlopCounterMode(display=False) as once:
            c = ref.conditions(req, torch.device("meta"))
            ref.vae.decode_video(c["start"])
        with FlopCounterMode(display=False) as step:
            ref.forward(c, c["start"], 0)
        return float(once.get_total_flops() + req["steps"] * step.get_total_flops())


class Capture:
    """For the request that ``begin(keep=True)`` marks: the UNet's input,
    timestep and output at every step (the first step's encoder states and
    micro-conditioning too), the latents each Euler step starts from, the
    video and the last latents. A kept request replaces the one kept before
    it. References only: nothing is copied or read back, so the capture
    adds no synchronisation to the timed path."""

    def __init__(self, unet: torch.nn.Module):
        import animate_anything_tpu_torch.pipelines.svd as svd

        self.record = None
        self._rec = None
        self._handle = unet.register_forward_hook(self._hook)
        self._svd, self._euler = svd, svd.euler_step
        svd.euler_step = self._step

    def _hook(self, _module, args, out):
        rec = self._rec
        if rec is None:
            return
        inp, t, embeds, added = args[:4]
        if not rec["out"]:
            rec.update(input0=inp, embeds=embeds, added=added)
        rec["t"].append(t)
        rec["out"].append(out)

    def _step(self, sample, *args, **kw):
        if self._rec is not None:
            self._rec["x"].append(sample)
        return self._euler(sample, *args, **kw)

    def begin(self, keep: bool = True) -> None:
        self._rec = dict(x=[], t=[], out=[]) if keep else None

    def finish(self, result) -> None:
        if self._rec is not None:
            video, latents = result
            self._rec.update(video=video, latents=latents)
            self.record = self._rec
        self._rec = None

    def remove(self) -> None:
        self._handle.remove()
        self._svd.euler_step = self._euler
