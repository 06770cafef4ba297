"""``animate_anything_512``: the port's mask + motion pipeline
(``pipelines/latent2video.py::LatentToVideoPipeline``) over the 3D UNet,
the SD VAE and the CLIP text encoder, and the plain reference over the same
drawn weights.

The request loop calls, on ``System``: ``shapes``, ``build_program``,
``make_request``, ``run_request``, ``capture``, ``span_targets``,
``reference`` and ``check``; the train loop ``train_step`` and its kin.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import weights as W
from perfbench.harness.system import PortSystem
from perfbench.harness.system import cast as cast_all
from perfbench.harness.traffic import rect_mask
from perfbench.reference.latent2video import Request, check
from perfbench.reference.numerics import Numerics, strict_fp32
from perfbench.reference.train import TrainStep

COMPONENTS = ("unet", "vae", "text_encoder")


class System(PortSystem):
    COMPONENTS = COMPONENTS

    def port_modules(self, cast: bool = True, checkpointing: bool = False) -> dict:
        from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
        from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
        from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig

        cfg = self.cfg
        u = dict(cfg["unet"])
        for k in ("down_block_types", "up_block_types", "block_out_channels"):
            u[k] = tuple(u[k])
        v = dict(cfg["vae"])
        v["block_out_channels"] = tuple(v["block_out_channels"])
        t = cfg["text_encoder"]
        with torch.device("meta"):
            mods = {"unet": UNet3DConditionModel(UNet3DConfig(
                        **u, gradient_checkpointing=checkpointing)),
                    "vae": AutoencoderKL(VAEConfig(**v)),
                    "text_encoder": CLIPTextModel(CLIPTextConfig(
                        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                        num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                        intermediate_size=t["intermediate_size"],
                        max_position_embeddings=t["max_position_embeddings"],
                        hidden_act=t["hidden_act"]))}
        return cast_all(mods) if cast else mods

    def build_program(self, weights: dict):
        from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
        from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

        mods = self.load(weights)
        t = self.cfg["text_encoder"]
        return LatentToVideoPipeline(
            mods["unet"], mods["vae"], text_encoder=mods["text_encoder"],
            tokenizer=HashTokenizer(t["vocab_size"], t["max_position_embeddings"]))

    # -- traffic --------------------------------------------------------------

    def make_request(self, traffic: dict, seed: int, index: int) -> dict:
        """Request ``index`` of the seed: an image, a mask rectangle of
        ``mask_area`` of it, a motion strength, one of the prompts, the start
        noise. Every request has the same sizes."""
        rng = np.random.default_rng([int(seed) % 2**63, index + 1])
        res, frames = traffic["resolution"], traffic["frames"]
        image = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
        mask = rect_mask(rng, res, traffic["mask_area"])
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(2**62)))
        noise = torch.randn((1, frames, res // 8, res // 8, 4), generator=gen,
                            device=self.device)
        prompts = traffic["prompts"]
        return dict(image=image, mask=mask, strength=float(rng.uniform(*traffic["strength"])),
                    prompt=prompts[int(rng.integers(len(prompts)))], noise=noise,
                    frames=frames, steps=traffic["steps"], guidance=traffic["guidance"])

    def run_request(self, program, req: dict):
        return program.animate_image(
            req["image"], req["prompt"], mask_img=req["mask"], motion_strength=req["strength"],
            num_frames=req["frames"], num_inference_steps=req["steps"],
            guidance_scale=req["guidance"], noise=req["noise"])

    def capture(self, program) -> "Capture":
        return Capture(program.unet)

    def span_targets(self, program) -> list:
        """(span name, module) or (span name, owner, attribute) of the calls
        the per-layer readers time."""
        import animate_anything_tpu_torch.pipelines.latent2video as l2v

        return [("unet", program.unet), ("vae_decode", l2v, "decode_video")]

    # -- the reference ---------------------------------------------------------

    def reference(self, weights: dict, numerics: str = "fp32") -> Request:
        strict_fp32()
        return Request({c: W.as_fp32(weights[c]) for c in COMPONENTS}, self.cfg,
                       Numerics(numerics))

    def check(self, ref: Request, req: dict, rec: dict, checks: dict) -> dict:
        return check(ref, req, rec, checks["unet_steps"], self.device)

    def request_flops(self, traffic: dict) -> float:
        """The FLOP of one request, counted over the reference's flow at the
        traffic's shapes on the meta device (products only): the encodes,
        one CFG forward of the UNet times the steps, the decode."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = self.meta_weights()
        ref = Request(meta, self.cfg, Numerics("fp32"))
        req = self.make_request(traffic, 0, 0)
        req["noise"] = torch.empty(req["noise"].shape, device="meta")
        with FlopCounterMode(display=False) as once:
            c = ref.conditions(req, torch.device("meta"))
            ref.vae.decode_video(c["start"])
        with FlopCounterMode(display=False) as step:
            ref.forward(c, c["start"], int(c["ts"][0]))
        return float(once.get_total_flops() + len(c["ts"]) * step.get_total_flops())


    # -- the finetune step ---------------------------------------------------------

    def build_trainer(self, weights: dict, seed: int) -> dict:
        """``train.py``'s full finetune as ``cli.main`` builds it: the float32
        modules, the masters of every UNet parameter taken before the cast to
        the policy, AdamW, the step with the VAE and text encodes inside, one
        generator seeded by the run."""
        from animate_anything_tpu_torch.diffusion import make_schedule
        from animate_anything_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                              make_train_step)

        tc = self.cfg["train"]
        mods = self.load(weights, cast=False, checkpointing=tc["gradient_checkpointing"])
        conf = TrainConfig(
            learning_rate=tc["learning_rate"], adam_beta1=tc["adam_beta1"],
            adam_beta2=tc["adam_beta2"], adam_eps=tc["adam_eps"],
            adam_weight_decay=tc["adam_weight_decay"], max_grad_norm=tc["max_grad_norm"],
            trainable_modules=tuple(tc["trainable_modules"]), text_dropout=tc["text_dropout"],
            motion_mask=True, motion_strength=True, rescale_schedule=tc["rescale_schedule"],
            motion_loss_weight=tc["motion_loss_weight"])
        state = create_train_state(mods["unet"], conf)
        cast_all(mods)
        sched = self.cfg["scheduler"]
        schedule = make_schedule(sched["num_train_timesteps"], sched["beta_schedule"],
                                 sched["beta_start"], sched["beta_end"], tc["objective"],
                                 tc["rescale_schedule"])
        step = make_train_step(schedule, conf, vae=mods["vae"],
                               text_encoder=mods["text_encoder"], device=self.device)
        return dict(state=state, step=step, conf=conf,
                    generator=torch.Generator(device=self.device).manual_seed(
                        int(seed) % 2**63))

    def make_batch(self, traffic: dict, seed: int, index: int) -> dict:
        """Batch ``index`` of the seed, made on the device: clips of an image
        drifting a few pixels a frame, a mask rectangle each, a prompt each
        and the empty prompt's ids for the text dropout."""
        from perfbench.reference.clip_text import hash_token_ids

        rng = np.random.default_rng([int(seed) % 2**63, 1_000_000 + index])
        b, res, f = traffic["batch"], traffic["resolution"], traffic["frames"]
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(2**62)))
        base = torch.rand((b, res, res, 3), generator=gen, device=self.device) * 2 - 1
        clips, masks = [], torch.zeros((b, res, res), device=self.device)
        for i in range(b):
            dy, dx = (int(v) for v in rng.integers(-traffic["drift_px"], traffic["drift_px"] + 1,
                                                   2))
            clips.append(torch.stack([base[i].roll((k * dy, k * dx), (0, 1))
                                      for k in range(f)]))
            masks[i] = torch.as_tensor(rect_mask(rng, res, traffic["mask_area"]),
                                       device=self.device)
        t = self.cfg["text_encoder"]
        prompts = [traffic["prompts"][int(rng.integers(len(traffic["prompts"])))]
                   for _ in range(b)]
        ids = hash_token_ids(prompts + [""] * b, t["vocab_size"], t["max_position_embeddings"])
        ids = ids.to(self.device)
        return {"pixel_values": torch.stack(clips), "mask": masks, "prompt_ids": ids[:b],
                "uncond_ids": ids[b:]}

    def train_step(self, trainer: dict, batch: dict) -> dict:
        return trainer["step"](trainer["state"], dict(batch), trainer["generator"])

    def masters(self, trainer: dict) -> dict:
        return trainer["state"].masters

    def first_gradients(self, trainer: dict) -> dict:
        """The gradient the optimizer took in its first step, from its first
        moment: μ₁ = (1 − β₁)·g."""
        opt = trainer["state"].optimizer
        b1 = trainer["conf"].adam_beta1
        return {k: v / (1.0 - b1) for k, v in opt.mu.items()}

    def trainer_spans(self) -> list:
        import animate_anything_tpu_torch.train.trainer as tr

        return [("optimizer", tr, "apply_gradients")]

    def train_reference(self, weights: dict, numerics: str = "fp32") -> TrainStep:
        strict_fp32()
        dtypes = {k.split(".", 1)[1]: dt for k, (_, dt) in self.shapes().items()
                  if k.startswith("unet.")}
        return TrainStep({c: W.as_fp32(weights[c]) for c in COMPONENTS}, self.cfg,
                         Numerics(numerics), dtypes)

    def step_flops(self, traffic: dict) -> float:
        """The FLOP of one step: the encodes, and the UNet's forward and
        backward for each row without recomputation, counted over the
        reference on the meta device (products only)."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = self.meta_weights()
        ref = TrainStep(meta, self.cfg, Numerics("fp32"), {})
        ref.unet.remat = False
        b, res, f = traffic["batch"], traffic["resolution"], traffic["frames"]
        batch = {"pixel_values": torch.empty(b, f, res, res, 3, device="meta"),
                 "mask": torch.empty(b, res, res, device="meta"),
                 "prompt_ids": torch.zeros(b, 77, dtype=torch.long, device="meta"),
                 "uncond_ids": torch.zeros(b, 77, dtype=torch.long, device="meta")}
        with FlopCounterMode(display=False) as once:
            lat, cond, mask, motion, text, _ = ref.inputs(batch)
        with FlopCounterMode(display=False) as row:
            pred = ref.unet(lat[:1], torch.zeros(1, device="meta"), text[:1], cond[:1],
                            mask[:1], motion[:1])
            pred.square().mean().backward()
        return float(once.get_total_flops() + b * row.get_total_flops())


class Capture:
    """Keeps, for the request that ``begin(keep=True)`` marks, what the UNet
    was given and gave at every step (its CFG pair) and, from the first
    step, the text states, the condition latent, the mask and the strength;
    ``finish`` adds the video and the last latents. A kept request replaces
    the one kept before it. References only: nothing is copied or read back."""

    def __init__(self, unet: torch.nn.Module):
        self.record = None
        self._rec = None
        self._handle = unet.register_forward_hook(self._hook)

    def _hook(self, _module, args, out):
        rec = self._rec
        if rec is None:
            return
        sample, t, text, cond, mask, motion = args[:6]
        b = sample.shape[0] // 2
        if not rec["x"]:
            rec.update(text=text, cond=cond, mask=mask, motion=motion)
        rec["x"].append(sample[:b])
        rec["t"].append(t)
        rec["out"].append(out)

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
