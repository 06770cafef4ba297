"""Trainer core for the mask+motion video-diffusion workload — the port of
``animate_anything_tpu/train/trainer.py``: the full finetune
(``make_train_step``) and LoRA (``make_lora_train_step``), AdamW or the
blockwise 8-bit AdamW (``ops/adam8bit.py``).

Step semantics as JAX's ``make_train_step``:

- latents from the batch or from the frozen VAE encode of the pixels
  (posterior mode), fp32; the condition latent is frame 0; the mask is
  resized to latent resolution and binarised at 0.5;
- ``motion_mask``: latents freeze-blended to the condition frame outside the
  mask; the motion condition is ``latent_motion_score`` of the blended clip,
  with the auxiliary loss 0.001·MSE(score(x̂0), score) under
  ``motion_strength``;
- ε or v target per schedule; offset noise unless the schedule is rescaled;
- whole-batch text-conditioning dropout.

The random draws (noise, t, dropout) come from outside ``loss_fn``, so a
test can feed it JAX's own; ``make_train_step`` draws them from a
``torch.Generator``. Precision as JAX's ``Policy``: the optimizer keeps fp32
masters of the trainable parameters (``core/dtypes.master_params``) and
updates them in place; the working module, whose weights the kernels read,
gets them back rounded after each update. Freezing follows JAX's flax-path
patterns through ``utils/convert.flax_path``; the optimizer is optax's
``MultiSteps(multi_transform({"train": chain(clip_by_global_norm, adamw),
"freeze": set_to_zero}))`` written out. The text encoder and the VAE run
frozen under ``torch.no_grad()`` (the text encoder under grad with text
LoRA); the UNet keeps ``eval()`` mode, as JAX's step applies it with
``deterministic=True``.

LoRA (JAX's ``make_lora_train_step``): the state holds only the adapter
tree(s) (fp32) and their optimizer, no masters of the base. Each step merges
the adapter into fp32 copies of the adapted base kernels, casts the merged
weights to the module's dtype and runs the UNet (and, with text LoRA, the
CLIP encoder) with them in place of its parameters (``models/lora.substituted``)
through the forward and the backward, so the kernels and the checkpointed
recomputation read them and the gradients reach the adapter alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from animate_anything_tpu_torch.core.dtypes import copy_masters_, master_params
from animate_anything_tpu_torch.diffusion.schedule import (DiffusionSchedule, add_noise,
                                                           get_velocity, make_schedule,
                                                           pred_x0, sample_noise)
from animate_anything_tpu_torch.metrics.motion import latent_motion_score
from animate_anything_tpu_torch.models.layers import resize_nearest
from animate_anything_tpu_torch.models.vae import encode_video
from animate_anything_tpu_torch.utils.convert import flax_path
from animate_anything_tpu_torch.utils.tracing import span, sync, traced


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    adam_weight_decay: float = 1e-2
    use_8bit_adam: bool = False
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    trainable_modules: Tuple[str, ...] = ("all",)
    not_trainable_modules: Tuple[str, ...] = ()
    text_dropout: float = 0.15
    motion_mask: bool = False
    motion_strength: bool = False
    use_offset_noise: bool = False
    offset_noise_strength: float = 0.1
    rescale_schedule: bool = False
    cache_latents: bool = False
    motion_loss_weight: float = 0.001


def mask_motion_finetune() -> Tuple[TrainConfig, DiffusionSchedule]:
    """The flagship finetune, ``configs/train_mask_motion.yaml``: motion
    mask and strength on, zero-terminal-SNR schedule (so no offset noise),
    every parameter trained, AdamW at lr 5e-6 without weight decay.

    The objective is an assumption, not a value of the YAML: the YAML names
    no prediction type, and JAX's ``schedule_from_json`` defaults to ε when
    no scheduler config is given. The scheduler config of the published
    checkpoint decides it, and the repo does not hold that file. Until it
    does, this takes v-prediction, the objective a zero terminal SNR needs
    (ε carries no signal at ᾱ = 0, and the motion loss's
    x̂0 = (x − sqrt(1−ᾱ)·ε)/sqrt(ᾱ) divides by 0 at t = 999)."""
    config = TrainConfig(learning_rate=5e-6, adam_weight_decay=0.0, motion_mask=True,
                         motion_strength=True, rescale_schedule=True,
                         trainable_modules=("all",))
    return config, make_schedule(prediction_type="v_prediction", rescale_betas_zero_snr=True)


def trainable_label_tree(model: nn.Module, trainable_modules: Tuple[str, ...],
                         not_trainable_modules: Tuple[str, ...] = (),
                         path: Callable[[str, int], str] = flax_path) -> Dict[str, str]:
    """'train' / 'freeze' per parameter name, by JAX's rule on the parameter's
    flax path (``path(name, ndim)``: the UNet3D's by default,
    ``utils/convert.svd_flax_path`` for the SVD UNet): the deny-list first;
    'all' trains everything; otherwise a parameter trains if a pattern is a
    substring of its path and the path holds no 'lora'."""
    return label_paths({name: path(name, p.ndim) for name, p in model.named_parameters()},
                       trainable_modules, not_trainable_modules)


def label_paths(paths: Dict[str, str], trainable_modules: Tuple[str, ...],
                not_trainable_modules: Tuple[str, ...] = ()) -> Dict[str, str]:
    """{name: flax path} → {name: 'train' | 'freeze'} by ``trainable_label_tree``'s
    rule."""

    def label(path: str) -> str:
        if any(tm in path for tm in not_trainable_modules):
            return "freeze"
        for tm in trainable_modules:
            if tm == "all" or (tm in path and "lora" not in path):
                return "train"
        return "freeze"

    return {name: label(path) for name, path in paths.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over the tensors, in fp32 (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.stack(norms).square().sum().sqrt()


def _split_sq(sq: Dict[str, torch.Tensor], tp_names) -> torch.Tensor:
    """[Σ‖g‖² of the arrays the tensor axis replicates, Σ‖g‖² of those it
    splits], fp32 on the first tensor's device."""
    dev = next(iter(sq.values())).device
    rep = [v for n, v in sq.items() if n not in tp_names]
    split = [v for n, v in sq.items() if n in tp_names]
    zero = torch.zeros((), device=dev)
    return torch.stack([torch.stack(rep).sum() if rep else zero,
                        torch.stack(split).sum() if split else zero])


def tensor_norm(sq: torch.Tensor, tp=None) -> torch.Tensor:
    """sqrt of ``_split_sq``'s pair with the split arrays' part summed over
    the tensor axis: each slice counted once, each replicated array once."""
    if tp is not None:
        from animate_anything_tpu_torch.parallel.tensor import reduce_from

        sq = torch.stack([sq[0], reduce_from(sq[1:], tp)[0]])
    return sq.sum().sqrt()


def sharded_global_norm(grads: Dict[str, torch.Tensor], tp=None, tp_names=()) -> torch.Tensor:
    """``global_norm`` of whole-on-this-rank gradients, those of arrays split
    over the tensor axis counted once a slice."""
    if not grads:
        return torch.zeros(())
    if tp is None:
        return global_norm(grads.values())
    sq = {n: torch.linalg.vector_norm(g, dtype=torch.float32).square() for n, g in grads.items()}
    return tensor_norm(_split_sq(sq, tp_names), tp)


def accumulate(opt, grads: Dict[str, Optional[torch.Tensor]],
               masters: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """One micro-step's gradients for ``opt.names`` (None counts as zero), the
    part of each that this rank updates (``opt.own``: all of it without a
    ZeRO plan), or under ``MultiSteps`` (``opt.acc``) their running mean:
    None until the k-th micro-step, then the mean."""
    grads = {n: opt.own(torch.zeros_like(masters[n]) if grads.get(n) is None else grads[n], n)
             for n in opt.names}
    if opt.acc is None:
        return grads
    for chunk in _chunks(opt.names, grads):
        acc = [opt.acc[n] for n in chunk]
        g = [grads[n].float() for n in chunk]
        torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(g, acc),
                                                    float(opt.mini_step + 1)))
    opt.mini_step += 1
    if opt.mini_step < opt.k:
        return None
    opt.mini_step = 0
    return opt.acc


def clip_factor(grads: Dict[str, torch.Tensor], max_norm: float, plan=None, tp=None,
                tp_names=()) -> float:
    """optax's ``clip_by_global_norm`` as a factor on every gradient. Under a
    ZeRO plan ``grads`` are this rank's parts, and the norm is taken over the
    whole gradient: each array's ‖part‖² (a replicated array's on rank 0
    alone), all-reduced over the data axis, summed. Under a tensor axis
    (``tp``) the arrays in ``tp_names`` are this rank's slices, summed over
    the axis as well, so each slice counts once."""
    if not grads:
        return 1.0
    with span("norm"):
        if plan is None and tp is None:
            norm = sync(float, global_norm(grads.values()))
        else:
            sq = {n: torch.linalg.vector_norm(g, dtype=torch.float32).square()
                  if plan is None or plan.sharded(n) or plan.rank == 0
                  else g.new_zeros((), dtype=torch.float32) for n, g in grads.items()}
            pair = _split_sq(sq, tp_names)
            if plan is not None:
                plan.all_reduce_sum_(pair)
            norm = sync(float, tensor_norm(pair, tp))
    return 1.0 if norm < max_norm else max_norm / norm


CHUNK = 1 << 26   # elements per foreach chunk


def _chunks(names, tensors: Dict[str, torch.Tensor]):
    chunk, size = [], 0
    for n in names:
        chunk.append(n)
        size += tensors[n].numel()
        if size >= CHUNK:
            yield chunk
            chunk, size = [], 0
    if chunk:
        yield chunk


class AdamW:
    """optax's ``adamw`` after ``clip_by_global_norm``, on the trainable
    masters only, inside ``MultiSteps`` when ``gradient_accumulation_steps``
    > 1 (the running mean of the micro-steps' gradients; an update every k
    steps). In place on the fp32 masters, in chunks so the fp32 temporaries
    stay small at full width.

    Per trainable p with gradient g: g ← g·max_norm/‖g‖ when ‖g‖ ≥ max_norm
    (the norm over trainable gradients only); μ ← b1·μ + (1 − b1)·g;
    ν ← b2·ν + (1 − b2)·g²; u = μ/(1 − b1ⁿ) / (sqrt(ν/(1 − b2ⁿ)) + eps);
    p ← p − lr·(u + wd·p). Frozen parameters are never touched.

    ``plan`` (``parallel/partition.ZeroPlan``, data parallelism): the moments
    and the accumulator hold this rank's flat slice of each sharded array;
    the rank updates that slice of the masters with the same elementwise
    math, then the masters are all-gathered. ``state_dict`` gathers the
    whole state to rank 0's host; ``load_state_dict`` takes any rank
    count's. ``tp`` and ``tp_names`` (tensor parallelism): the masters in
    ``tp_names`` are this rank's slices (``parallel/tensor.py``), which the
    clipping norm counts once each."""

    STATE = ("mu", "nu")
    BLOCK_STATE: tuple = ()       # per-block state (the 8-bit scales)

    def __init__(self, config: TrainConfig, masters: Dict[str, torch.Tensor], plan=None,
                 tp=None, tp_names=()):
        self.config = config
        self.plan = plan
        self.tp, self.tp_names = tp, frozenset(tp_names)
        self.names = list(masters)
        self.shapes = {n: tuple(p.shape) for n, p in masters.items()}
        self._init_moments(masters)
        self.count = 0
        self.k = config.gradient_accumulation_steps
        self.mini_step = 0
        self.acc = ({n: torch.zeros_like(self.own(p, n)) for n, p in masters.items()}
                    if self.k > 1 else None)

    def own(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The part of a full-shaped tensor that this rank updates."""
        return t if self.plan is None else self.plan.view(t, name)

    def _init_moments(self, masters: Dict[str, torch.Tensor]) -> None:
        self.mu = {n: torch.zeros_like(self.own(p, n)) for n, p in masters.items()}
        self.nu = {n: torch.zeros_like(self.own(p, n)) for n, p in masters.items()}

    def state_bytes(self) -> int:
        """Bytes of this rank's optimizer moments (``STATE``)."""
        return sum(t.numel() * t.element_size() for key in self.STATE
                   for t in getattr(self, key).values())

    def _finish(self, masters: Dict[str, torch.Tensor]) -> None:
        """After an update: zero the accumulator; make the masters whole."""
        if self.acc is not None:
            for t in self.acc.values():
                t.zero_()
        if self.plan is not None:
            self.plan.all_gather_(masters, self.names)

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]],
             masters: Dict[str, torch.Tensor]) -> bool:
        """Take one micro-step's gradients of the trainable parameters (any
        dtype; None counts as zero; averaged over the data axis already).
        Returns whether the masters changed."""
        cfg = self.config
        grads = accumulate(self, grads, masters)
        if grads is None:
            return False
        clip = clip_factor(grads, cfg.max_grad_norm, self.plan, self.tp, self.tp_names)
        self.count += 1
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for chunk in _chunks(self.names, grads):
            g = [grads[n].float() for n in chunk]
            if clip != 1.0:
                g = torch._foreach_mul(g, clip)
            mu, nu = [self.mu[n] for n in chunk], [self.nu[n] for n in chunk]
            p = [self.own(masters[n], n) for n in chunk]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.adam_eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            if cfg.adam_weight_decay:
                torch._foreach_add_(upd, p, alpha=cfg.adam_weight_decay)
            torch._foreach_add_(p, upd, alpha=-cfg.learning_rate)
        self._finish(masters)
        return True

    def state_dict(self) -> Optional[dict]:
        """The state: the live tensors, or under a plan every rank's slices
        gathered whole on rank 0's host (a collective: every rank calls it;
        the other ranks get None)."""
        if self.plan is None:
            out = {key: getattr(self, key) for key in self.STATE}
            out.update(count=self.count, mini_step=self.mini_step, acc=self.acc)
            return out
        keys = self.STATE + (("acc",) if self.acc is not None else ())
        whole = self.plan.gather_to_main({
            (key, n): (n, t, (-1,) if key in self.BLOCK_STATE else self.shapes[n],
                       key in self.BLOCK_STATE)
            for key in keys for n, t in getattr(self, key).items()})
        if whole is None:
            return None
        out = {key: {n: whole[key, n] for n in self.names} for key in keys}
        out.update(count=self.count, mini_step=self.mini_step, acc=out.get("acc"))
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` (whole tensors, the same names and shapes,
        written at any rank count) into this optimizer's tensors."""
        def take(key, n, full):
            if self.plan is None:
                return full
            if key in self.BLOCK_STATE:
                return self.plan.block_view(full, n)
            return self.plan.view(full.contiguous(), n)

        for key in self.STATE:
            for n, t in getattr(self, key).items():
                t.copy_(take(key, n, state[key][n]).reshape(t.shape))
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        if self.acc is not None:
            for n, t in self.acc.items():
                t.copy_(take("acc", n, state["acc"][n]).reshape(t.shape))


def make_optimizer(config: TrainConfig, masters: Dict[str, torch.Tensor], mesh=None,
                   min_shard_size: int = 2 ** 14, model: Optional[nn.Module] = None):
    """AdamW, or the blockwise 8-bit AdamW under ``use_8bit_adam`` (JAX's
    ``adamw_8bit``), on ``masters``; its state split over ``mesh``'s data
    axis (``parallel/partition.zero_plan``: arrays under ``min_shard_size``
    elements replicated) where a process group exists, on the local slices
    of a ``parallel/tensor.shard_model``-ed ``model``."""
    from animate_anything_tpu_torch.parallel.partition import zero_plan
    from animate_anything_tpu_torch.parallel.tensor import model_plan

    plan = zero_plan({n: p.numel() for n, p in masters.items()}, mesh, min_shard_size)
    tp, tplan = model_plan(model)
    tensor = (tp, [n for n in masters if n in tplan])
    if config.use_8bit_adam:
        from animate_anything_tpu_torch.ops.adam8bit import AdamW8bit

        return AdamW8bit(config, masters, plan, *tensor)
    return AdamW(config, masters, plan, *tensor)


@dataclasses.dataclass
class TrainState:
    """The trained tensors and their optimizer. Full finetune: the working
    module (compute dtypes, read by the kernels) and the fp32 masters of its
    trainable parameters. LoRA: no module; ``params`` is {"unet_lora": …,
    "text_lora": …}, a key for each adapter in use, and ``masters`` the same
    tensors by flat name (``flatten_lora``)."""
    model: Optional[nn.Module]
    masters: Dict[str, torch.Tensor]
    optimizer: Any
    labels: Dict[str, str]
    step: int = 0
    params: Any = None


def create_train_state(model: nn.Module, config: TrainConfig,
                       path: Callable[[str, int], str] = flax_path, mesh=None,
                       min_shard_size: int = 2 ** 14) -> TrainState:
    """fp32 masters of ``model``'s trainable parameters (exact where the
    module is still fp32, as ``cli.main`` makes them before the cast);
    ``path`` names the parameters' flax paths for the labels; ``mesh``
    (``core/mesh.create_mesh``) splits the optimizer state over its data
    axis where a process group exists (``make_optimizer``)."""
    labels = trainable_label_tree(model, config.trainable_modules, config.not_trainable_modules,
                                  path)
    masters = master_params(model, [n for n, lab in labels.items() if lab == "train"])
    for p in model.parameters():        # frozen ones too: grad_norm counts every gradient
        p.requires_grad_(True)
    return TrainState(model, masters,
                      make_optimizer(config, masters, mesh, min_shard_size, model), labels)


def flatten_lora(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """An adapter tree, or a dict of them, → {JAX path string: tensor}
    (``unet_lora.<path>.down`` …, as JAX's tree paths read)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_lora(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def create_lora_train_state(tree: dict, config: TrainConfig, mesh=None,
                            min_shard_size: int = 2 ** 14) -> TrainState:
    """A state that trains ``tree`` ({"unet_lora": …, "text_lora": …} of
    fp32 adapter tensors, in place): labels by JAX's rule on JAX's paths,
    the optimizer on the 'train' ones. JAX's state is the bare UNet adapter
    when no text adapter is trained, and its rule reads those paths (with
    ``unet_lora.`` in front, "lora" in a path leaves only 'all' to train)."""
    masters = flatten_lora(tree)
    for t in masters.values():
        t.requires_grad_(True)
    jax_paths = {n: n if "text_lora" in tree else n[len("unet_lora."):] for n in masters}
    labels = label_paths(jax_paths, config.trainable_modules, config.not_trainable_modules)
    train = {n: t for n, t in masters.items() if labels[n] == "train"}
    return TrainState(None, masters, make_optimizer(config, train, mesh, min_shard_size), labels,
                      params=tree)


def prepare_mask_for_latents(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(b, H, W) 0..255 → (b, 1, h, w, 1) fp32 in {0, 1}: /255, nearest
    resize with ``jax.image.resize``'s half-pixel convention, ≥ 0.5."""
    m = resize_nearest(mask.float()[..., None] / 255.0, (h, w))[..., 0]
    return (m >= 0.5).float()[:, None, :, :, None]


@torch.no_grad()
def batch_latents(batch: dict, vae: Optional[nn.Module] = None) -> torch.Tensor:
    """fp32 latents of a batch: its cached ``latents``, or the frozen VAE
    encode of its ``pixel_values`` (b, f, H, W, 3) in [-1, 1]."""
    if "latents" in batch:
        return batch["latents"].float()
    pixels = batch["pixel_values"]
    return encode_video(vae, pixels.to(next(vae.parameters()).dtype)).float()


def make_loss_fn(schedule: DiffusionSchedule, config: TrainConfig,
                 vae: Optional[nn.Module] = None,
                 text_encoder: Optional[nn.Module] = None,
                 text_grad: bool = False) -> Callable:
    """``loss_fn(model, batch, noise, t, drop) → (loss, metrics)``, pure in its
    random draws: ``noise`` (b, f, h, w, c) fp32 with any offset added, ``t``
    (b,) int timesteps, ``drop`` the text-dropout flag. Batch keys: as JAX's
    (``latents`` or ``pixel_values``; ``mask`` (b, H, W) 0..255;
    ``encoder_hidden_states`` + ``uncond_hidden_states`` or ``prompt_ids`` +
    ``uncond_ids``). ``text_grad`` (text LoRA) runs the text encoder under
    grad and refuses a batch without token ids, as JAX does: cached
    embeddings would bypass the trained adapter."""

    def loss_fn(model, batch, noise, t, drop):
        latents = batch_latents(batch, vae)
        b, f, h, w, _ = latents.shape
        condition_latent = latents[:, 0:1]
        mask = prepare_mask_for_latents(batch["mask"], h, w)
        if config.motion_mask:
            latents = condition_latent.expand_as(latents) * (1.0 - mask) + latents * mask
        latent_motion = latent_motion_score(latents)
        noisy = add_noise(schedule, latents, noise, t)

        if "encoder_hidden_states" in batch and not text_grad:
            embeds, uncond = batch["encoder_hidden_states"], batch["uncond_hidden_states"]
        else:
            if text_grad and "prompt_ids" not in batch:
                raise ValueError("text LoRA needs token ids in the batch; cached text "
                                 "embeddings would bypass the trained adapter")
            with torch.set_grad_enabled(text_grad and torch.is_grad_enabled()):
                embeds = text_encoder(batch["prompt_ids"])
                uncond = text_encoder(batch["uncond_ids"])
        embeds = uncond if sync(bool, drop) else embeds

        pred = model(noisy, t, embeds, condition_latent,
                     mask if config.motion_mask else None,
                     latent_motion if config.motion_strength else None)
        if schedule.prediction_type == "epsilon":
            target = noise
        elif schedule.prediction_type == "v_prediction":
            target = get_velocity(schedule, latents, noise, t)
        else:
            raise ValueError(schedule.prediction_type)
        loss = (pred.float() - target.float()).square().mean()
        metrics = {"mse_loss": loss}
        if config.motion_strength:
            x0 = pred_x0(schedule, pred, noisy, t)
            motion_loss = (latent_motion - latent_motion_score(x0)).square().mean()
            loss = loss + config.motion_loss_weight * motion_loss
            metrics["motion_loss"] = motion_loss
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


@traced("optimizer")
def apply_gradients(state: TrainState) -> float:
    """Hand the gradients to the optimizer, clear them; return the global
    norm of every gradient, frozen ones included (JAX's ``grad_norm``). Full
    finetune: the working module's gradients, updated masters rounded back
    into it. LoRA: the adapter tensors' own, updated in place. Under a ZeRO
    plan every gradient is first averaged over the data axis, so each rank
    holds the global batch's gradient; under a tensor axis the norm counts
    each slice of a split array once."""
    named = (dict(state.model.named_parameters()) if state.model is not None
             else state.masters)
    grads = {n: p.grad for n, p in named.items()}
    present = [g for g in grads.values() if g is not None]
    plan = getattr(state.optimizer, "plan", None)
    if plan is not None and present:
        plan.reduce_mean_(present)
    tp = getattr(state.optimizer, "tp", None)
    with span("norm"):
        if tp is None:
            norm = global_norm(present) if present else torch.zeros(())
        else:
            from animate_anything_tpu_torch.parallel.tensor import model_plan

            split = model_plan(state.model)[1]
            norm = sharded_global_norm({n: g for n, g in grads.items() if g is not None}, tp,
                                       [n for n in grads if n in split])
    with span("update"):
        changed = state.optimizer.step({n: grads.get(n) for n in state.optimizer.names},
                                       state.masters)
    if changed and state.model is not None:
        with span("masters"):
            copy_masters_(state.model, state.masters)
    for p in named.values():
        p.grad = None
    state.step += 1
    return sync(float, norm)


def draw_inputs(schedule: DiffusionSchedule, config: TrainConfig, shape: tuple,
                generator: torch.Generator, device) -> tuple:
    """A step's draws from ``generator``: the noise (with the offset unless
    the schedule is rescaled), the (b,) timesteps and the text-dropout flag."""
    offset = config.offset_noise_strength if (config.use_offset_noise
                                              and not config.rescale_schedule) else 0.0
    noise = sample_noise(tuple(shape), offset, generator=generator, device=device)
    t = torch.randint(0, schedule.num_train_timesteps, (shape[0],), generator=generator,
                      device=device)
    drop = torch.rand((), generator=generator, device=device) < config.text_dropout
    return noise, t, drop


def rows_of(mesh, b: int) -> slice:
    """This rank's rows of a global batch of ``b`` rows (all of them without
    a mesh)."""
    if mesh is None:
        return slice(0, b)
    from animate_anything_tpu_torch.core.mesh import row_range

    return slice(*row_range(b, mesh))


def global_rows(mesh, b_local: int) -> int:
    """The global batch's rows: every data rank holds ``b_local``."""
    return b_local * (1 if mesh is None else mesh.size("data"))


def mean_metrics(metrics: dict, state: TrainState) -> dict:
    """The step's metrics as floats, averaged over the data axis under a
    ZeRO plan (equal rows a rank, so the mean of the ranks' means is the
    global batch's)."""
    plan = getattr(state.optimizer, "plan", None)
    if plan is None:
        return {k: sync(float, v.detach()) for k, v in metrics.items()}
    vals = plan.all_reduce_sum_(torch.stack([v.detach().float() for v in metrics.values()]))
    return {k: float(v) for k, v in zip(metrics, sync((vals / plan.ranks).tolist))}


def _on_device(batch: dict, device, vae) -> dict:
    batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
    batch["latents"] = batch_latents(batch, vae)
    return batch


def _check_device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' for the CPU)")
    return device


def draw_rows(schedule: DiffusionSchedule, config: TrainConfig, shape: tuple,
              generator: torch.Generator, device, mesh=None) -> tuple:
    """``draw_inputs`` for the global batch (every data rank draws the same
    values from the same generator), then this rank's rows of the noise and
    t; the dropout flag is one for the batch."""
    b = global_rows(mesh, shape[0])
    noise, t, drop = draw_inputs(schedule, config, (b,) + tuple(shape[1:]), generator, device)
    rows = rows_of(mesh, b)
    return noise[rows], t[rows], drop


def make_train_step(schedule: DiffusionSchedule, config: TrainConfig,
                    vae: Optional[nn.Module] = None, text_encoder: Optional[nn.Module] = None,
                    device="cuda", mesh=None) -> Callable:
    """``train_step(state, batch, generator) → metrics`` (floats: loss,
    mse_loss, motion_loss, grad_norm). Draws noise, t and the text-dropout
    flag from ``generator`` (on ``device``), then runs ``loss_fn``, the
    backward and the optimizer. Runs on the card unless ``device="cpu"``.

    ``mesh`` (data parallelism; the state made with the same mesh): the
    batch is this rank's rows of the global batch; the draws are the global
    batch's, sliced, so the step is the single-device step on the global
    batch, as JAX's sharded ``make_train_step`` is."""
    device = _check_device(device, "make_train_step")
    loss_fn = make_loss_fn(schedule, config, vae, text_encoder)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        with span("train_step"):
            with span("inputs"):
                batch = _on_device(batch, device, vae)
                noise, t, drop = draw_rows(schedule, config, batch["latents"].shape, generator,
                                           device, mesh)
            with span("loss"):
                _, metrics = loss_fn(state.model, batch, noise, t, drop)
            with span("backward"):
                metrics["loss"].backward()
            with span("metrics"):
                out = mean_metrics(metrics, state)
            out["grad_norm"] = apply_gradients(state)
            return out

    return train_step


def make_lora_train_step(schedule: DiffusionSchedule, config: TrainConfig, unet: nn.Module,
                         base: Optional[Dict[str, torch.Tensor]], lora_config,
                         text_encoder: Optional[nn.Module] = None,
                         text_base: Optional[Dict[str, torch.Tensor]] = None,
                         text_lora_config=None, vae: Optional[nn.Module] = None,
                         device="cuda", mesh=None) -> Callable:
    """``train_step(state, batch, generator) → metrics`` for a LoRA state
    (``create_lora_train_state``): the adapter(s) with rank dropout, merged
    into ``base`` / ``text_base`` (flax path → the adapted kernels' base,
    fp32 where JAX's parameters are), the merged weights in the modules'
    dtypes substituted for their parameters through the forward and the
    backward; then the optimizer on the adapter. Either model may be left
    unadapted: its config None and no key for it in ``state.params``. Runs
    on the card unless ``device="cpu"``; ``mesh`` as in ``make_train_step``
    (the rank-dropout draws are the adapter's, one for every rank)."""
    from animate_anything_tpu_torch.models import lora

    device = _check_device(device, "make_lora_train_step")
    text = text_lora_config is not None
    loss_fn = make_loss_fn(schedule, config, vae, text_encoder, text_grad=text)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        with span("train_step"):
            with span("inputs"):
                batch = _on_device(batch, device, vae)
                weights, text_weights = {}, {}
                if lora_config is not None:
                    unet_lora = lora.dropout_lora(state.params["unet_lora"], lora_config, generator)
                    weights = lora.merged_weights(unet, base, unet_lora, lora_config)
                if text:
                    text_lora = lora.dropout_lora(state.params["text_lora"], text_lora_config,
                                                  generator)
                    text_weights = lora.merged_weights(text_encoder, text_base, text_lora,
                                                       text_lora_config, naming="text")
                noise, t, drop = draw_rows(schedule, config, batch["latents"].shape, generator,
                                           device, mesh)
            with contextlib.ExitStack() as stack:
                stack.enter_context(lora.substituted(unet, weights))
                if text:
                    stack.enter_context(lora.substituted(text_encoder, text_weights))
                with span("loss"):
                    _, metrics = loss_fn(unet, batch, noise, t, drop)
                with span("backward"):
                    metrics["loss"].backward()
            with span("metrics"):
                out = mean_metrics(metrics, state)
            out["grad_norm"] = apply_gradients(state)
            return out

    return train_step
