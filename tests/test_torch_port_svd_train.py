"""The port's SVD training step (``train/svd_trainer.py``) and the SVD UNet's
gradient checkpointing against the JAX package, on the CPU in fp32.

- The loss: JAX's ``make_svd_train_step`` loss function (taken from the
  step's closure, so the JAX side is the package's own code) and the port's
  ``make_svd_loss_fn`` on the same weights and batch, JAX's draws (its
  ``jax.random.split`` of the step's key, replayed here) fed to the port as
  ``SVDDraws``; a two-level cut of ``SVDUNetConfig.tiny`` (9 channels, the
  motion mask) under ``"xla"`` and ``"pallas"`` (JAX's Pallas paths as its
  tests run them on the CPU), with and without the image-embedding dropout.
  The tiny UNet's loss and every gradient against ``jax.value_and_grad``
  are the slow tier (the JAX grad graph compiles for minutes).
- The gradients of the two checkpointed SVD blocks (``SpatioTemporalResBlock``:
  kernel 3 with the residual; ``TransformerSpatioTemporalModel``: kernel 1,
  kernel 2 and kernel 5) against ``jax.vjp`` under ``"pallas"``.
- Checkpointing: the tiny UNet's every gradient with it on equals the one
  without it (the backward recomputes the same forward).
- The draws' order and shapes; the trainer's freeze labels on the SVD
  UNet's flax paths.

Tolerances: the loss terms 2e-5 relative (fp32 summation-order noise
through the UNet; the VAE encode and the EDM weighting λ(σ) up to ~1e3
scale it); the gradients 5e-5 absolute, as ``test_torch_port_grads.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401
from test_torch_port_svd_modules import sub_state_dict

LOSS_RTOL, GRAD_ATOL = 2e-5, 5e-5
B, F, RES = 2, 3, 64
UNET_CUT = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4), layers_per_block=1)


def jax_svd_models(unet_kw: dict):
    """The JAX package's SVD UNet (``unet_kw`` on ``SVDUNetConfig.tiny``, 9
    channels), tiny VAE and CLIP vision tower with ``jax_params`` weights."""
    from animate_anything_tpu.models.clip_vision import CLIPVisionConfig
    from animate_anything_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxVis
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet
    from animate_anything_tpu.models.vae import AutoencoderKL, VAEConfig

    z = np.zeros((1, 2, 8, 8, 9), np.float32)
    up = jax_params(JaxUNet(JaxCfg.tiny(in_channels=9, attn_impl="xla", **unet_kw)), z,
                    np.float32(0.5), np.zeros((1, 1, 32), np.float32),
                    np.zeros((1, 3), np.float32))
    vae = AutoencoderKL(VAEConfig.tiny())
    icfg = CLIPVisionConfig.tiny(projection_dim=32)
    return dict(unet_params=up, vae=vae,
                vae_params=jax_params(vae, np.zeros((1, 32, 32, 3), np.float32), seed=1),
                image_encoder=JaxVis(icfg),
                image_encoder_params=jax_params(JaxVis(icfg), np.zeros((1, 32, 32, 3),
                                                                       np.float32), seed=2))


def port_svd_models(jm: dict, unet_kw: dict, impl: str, **cfg_kw):
    from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                               CLIPVisionModelWithProjection)
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.utils.convert import (clip_vision_state_dict,
                                                          svd_unet_state_dict, vae_state_dict)

    unet = load_into(UNetSpatioTemporalConditionModel(
        SVDUNetConfig.tiny(in_channels=9, attn_impl=impl, **unet_kw, **cfg_kw)),
        svd_unet_state_dict(jm["unet_params"]))
    vae = load_into(AutoencoderKL(VAEConfig.tiny()), vae_state_dict(jm["vae_params"]))
    ienc = load_into(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny(projection_dim=32)),
                     clip_vision_state_dict(jm["image_encoder_params"]))
    return unet, vae, ienc


def make_batch(seed: int = 0, res: int = RES) -> dict:
    r = np.random.default_rng(seed)
    mask = np.zeros((B, res, res), np.float32)
    mask[0, 8:40, 16:48] = 255.0
    mask[1, res // 2:, :] = 255.0
    return {"pixel_values": r.uniform(-1, 1, (B, F, res, res, 3)).astype(np.float32),
            "mask": mask,
            "clip_pixel_values": r.standard_normal((B, 32, 32, 3)).astype(np.float32)}


def jax_draws(rng, config, batch):
    """The draws JAX's loss function makes from ``rng`` (its own split)."""
    from animate_anything_tpu.diffusion.euler_edm import edm_sample_sigmas

    from animate_anything_tpu_torch.train.svd_trainer import SVDDraws

    r_aug, r_sigma, r_noise, r_drop = jax.random.split(rng, 4)
    px = batch["pixel_values"]
    z = jax.random.normal(r_aug, ())
    image_noise = jax.random.normal(jax.random.fold_in(r_aug, 1), px[:, 0].shape)
    sigma = edm_sample_sigmas(r_sigma, px.shape[0], config.p_mean, config.p_std)
    noise = jax.random.normal(r_noise, (*px.shape[:2], px.shape[2] // 8, px.shape[3] // 8, 4),
                              jnp.float32)
    drop = jax.random.bernoulli(r_drop, config.image_dropout)
    return SVDDraws(t(jnp.exp(-3.0 + 0.5 * z)), t(image_noise), t(sigma), t(noise),
                    torch.tensor(bool(drop)))


def jax_loss_fn(jm, config, impl, unet_kw):
    """JAX's loss function, out of ``make_svd_train_step``'s closure."""
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet
    from animate_anything_tpu.train.svd_trainer import make_svd_train_step

    step = make_svd_train_step(
        JaxUNet(JaxCfg.tiny(in_channels=9, attn_impl=impl, **unet_kw)), config, vae=jm["vae"],
        vae_params=jm["vae_params"], image_encoder=jm["image_encoder"],
        image_encoder_params=jm["image_encoder_params"])
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    return cells["loss_fn"]


def keys_by_drop(config):
    """A step key whose dropout draw keeps the embedding, and one that drops it."""
    found = {}
    for i in range(200):
        key = jax.random.PRNGKey(i)
        drop = bool(jax.random.bernoulli(jax.random.split(key, 4)[3], config.image_dropout))
        found.setdefault(drop, key)
        if len(found) == 2:
            return found[False], found[True]
    raise AssertionError("no key drops the embedding")


@pytest.fixture(scope="module")
def cut_models():
    return jax_svd_models(UNET_CUT)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_svd_loss_matches_jax(cut_models, impl):
    from animate_anything_tpu.train.svd_trainer import SVDTrainConfig as JaxTC

    from animate_anything_tpu_torch.train.svd_trainer import SVDTrainConfig, make_svd_loss_fn

    jcfg, cfg = JaxTC(motion_mask=True), SVDTrainConfig(motion_mask=True)
    batch = make_batch()
    loss_fn = jax.jit(jax_loss_fn(cut_models, jcfg, impl, UNET_CUT))
    unet, vae, ienc = port_svd_models(cut_models, UNET_CUT, impl)
    port_loss = make_svd_loss_fn(cfg, vae, ienc)
    tb = {k: t(v) for k, v in batch.items()}
    keys = keys_by_drop(jcfg) if impl == "xla" else keys_by_drop(jcfg)[:1]
    for key in keys:
        with pltpu.force_tpu_interpret_mode():
            _, want = loss_fn(cut_models["unet_params"], batch, key)
        draws = jax_draws(key, jcfg, batch)
        with torch.no_grad():
            _, got = port_loss(unet, tb, draws)
        assert set(got) == set(want) == {"edm_loss", "mask_consistency_loss", "loss"}
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=LOSS_RTOL,
                                       err_msg=f"{name}, drop {bool(draws.drop)}")


def test_draws_are_seeded_and_shaped():
    from animate_anything_tpu_torch.train.svd_trainer import SVDTrainConfig, draw_svd_inputs

    cfg = SVDTrainConfig()
    a = draw_svd_inputs(cfg, (B, F, RES, RES, 3), 4, torch.Generator().manual_seed(3), "cpu")
    b = draw_svd_inputs(cfg, (B, F, RES, RES, 3), 4, torch.Generator().manual_seed(3), "cpu")
    assert a.noise_aug.shape == () and a.drop.shape == () and a.drop.dtype == torch.bool
    assert a.image_noise.shape == (B, RES, RES, 3) and a.sigma.shape == (B, 1, 1, 1, 1)
    assert a.noise.shape == (B, F, RES // 8, RES // 8, 4)
    for x, y in zip(vars(a).values(), vars(b).values()):
        assert torch.equal(x, y)
    sig = torch.cat([draw_svd_inputs(cfg, (64, 1, 8, 8, 3), 4, torch.Generator().manual_seed(s),
                                     "cpu").sigma.flatten() for s in range(40)])
    assert abs(float(sig.log().mean()) - cfg.p_mean) < 0.15
    assert abs(float(sig.log().std()) - cfg.p_std) < 0.15


def test_svd_flax_paths_are_jaxs_and_label_the_same(cut_models):
    from animate_anything_tpu.train.trainer import trainable_label_tree as jax_labels

    from animate_anything_tpu_torch.train.trainer import trainable_label_tree
    from animate_anything_tpu_torch.utils.convert import svd_flax_path

    unet, _, _ = port_svd_models(cut_models, UNET_CUT, "xla")
    flat = jax.tree_util.tree_flatten_with_path(cut_models["unet_params"])[0]
    want_paths = {".".join(str(k.key) for k in path) for path, _ in flat}
    got = {name: svd_flax_path(name, p.ndim) for name, p in unet.named_parameters()}
    assert set(got.values()) == want_paths
    want = {".".join(str(k.key) for k in path): lab for path, lab in jax.tree_util.
            tree_flatten_with_path(jax_labels(cut_models["unet_params"],
                                              ("temporal", "attentions"), ("time_mixer",)))[0]}
    labels = trainable_label_tree(unet, ("temporal", "attentions"), ("time_mixer",),
                                  svd_flax_path)
    assert {got[k]: v for k, v in labels.items()} == want
    assert {"train", "freeze"} == set(labels.values())


def _vjp_check(jm, params, inputs, port, port_call, sd, static=()):
    """jax.vjp of ``jm.apply(params, *inputs, *static)`` against the port's
    autograd for the same random output cotangent, every input and
    parameter gradient within ``GRAD_ATOL``."""
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda p, *a: jm.apply(p, *a, *static), params,
                            *(jnp.asarray(a) for a in inputs))
        cot = np.random.default_rng(9).standard_normal(want.shape).astype(np.float32)
        cot /= np.sqrt(want.size / want.shape[-1])
        want_gp, *want_gin = vjp(jnp.asarray(cot))
    tin = [t(a).requires_grad_(True) for a in inputs]
    got = port_call(port, *tin)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    (got * t(cot)).sum().backward()
    for i, (g, w) in enumerate(zip(tin, want_gin)):
        np.testing.assert_allclose(n(g.grad), np.asarray(w), atol=GRAD_ATOL, err_msg=f"input {i}")
    want_p = sd(want_gp)
    named = dict(port.named_parameters())
    assert set(want_p) == set(named)
    for name, w in want_p.items():
        np.testing.assert_allclose(n(named[name].grad), n(w), atol=GRAD_ATOL, err_msg=name)


def test_spatio_temporal_res_block_grads_match_jax():
    """Kernel 3's two stages (GroupNorm eps 1e-6, the second with the
    residual) through their twins, the spatial resnet, the mixer."""
    from animate_anything_tpu.models.svd_unet import SpatioTemporalResBlock as JaxRes

    from animate_anything_tpu_torch.models.svd_unet import SpatioTemporalResBlock
    from animate_anything_tpu_torch.ops import temporal_conv

    r = np.random.default_rng(10)
    f, c = 4, 64
    x = r.standard_normal((B * f, 6, 6, c)).astype(np.float32)
    temb = r.standard_normal((B * f, 32)).astype(np.float32)
    jm = JaxRes(c, f, eps=1e-6, impl="pallas")
    p = jax_params(jm, x, temb, seed=11)
    port = load_into(SpatioTemporalResBlock(c, c, 32, 1e-6, "pallas"),
                     sub_state_dict(p, "down_blocks_0_resnets_0"))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(temporal_conv, "tap_conv",
                   lambda *a, _f=temporal_conv.tap_conv, **k: calls.append(1) or _f(*a, **k))
        _vjp_check(jm, p, (x, temb), port, lambda m, a, b: m(a, b, f),
                   lambda g: sub_state_dict(g, "down_blocks_0_resnets_0"))
    assert len(calls) == 2


def test_transformer_spatio_temporal_model_grads_match_jax():
    """16×16 latents (flash at s = 256, its Pallas backward in interpret mode
    on the JAX side), 3 frames, kernels 2 and 5 through their twins."""
    from animate_anything_tpu.models.svd_unet import TransformerSpatioTemporalModel as JaxTSTM

    from animate_anything_tpu_torch.models.svd_unet import TransformerSpatioTemporalModel

    r = np.random.default_rng(12)
    f = 3
    x = r.standard_normal((B * f, 16, 16, 32)).astype(np.float32)
    ctx = r.standard_normal((B, 1, 24)).astype(np.float32)
    jm = JaxTSTM(2, 16, 24, f, attn_impl="pallas")
    p = jax_params(jm, x, ctx, seed=13)
    port = load_into(TransformerSpatioTemporalModel(32, 2, 16, 24, "pallas"),
                     sub_state_dict(p, "down_blocks_0_attentions_0"))
    _vjp_check(jm, p, (x, ctx), port, lambda m, a, b: m(a, b, f),
               lambda g: sub_state_dict(g, "down_blocks_0_attentions_0"))


def _svd_grads(cfg_kw: dict, seed: int = 0) -> dict:
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import init_svd_unet_

    gen = torch.Generator().manual_seed(seed)
    model = init_svd_unet_(UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny(**cfg_kw)), gen)
    model.eval()
    r = np.random.default_rng(4)
    sample = t(r.standard_normal((B, F, 16, 16, cfg_kw.get("in_channels", 8))).astype(np.float32))
    ctx = t(r.standard_normal((B, 1, 32)).astype(np.float32))
    ids = torch.tensor([[6.0, 127.0, 0.02]] * B)
    out = model(sample, torch.tensor(0.3), ctx, ids)
    (out * t(r.standard_normal(out.shape).astype(np.float32))).sum().backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_svd_gradient_checkpointing_gives_the_same_gradients():
    """Each checkpointed block re-runs its forward in the backward
    (``models/unet3d_blocks.run_layer``): every gradient of the tiny UNet
    under "pallas" (the kernel wrappers' autograd Functions inside the
    checkpoint) equals the one without checkpointing."""
    off = _svd_grads(dict(in_channels=9, attn_impl="pallas"))
    on = _svd_grads(dict(in_channels=9, attn_impl="pallas", gradient_checkpointing=True))
    assert all(g is not None for g in off.values())
    for name, g in off.items():
        np.testing.assert_allclose(n(on[name]), n(g), atol=1e-6, err_msg=name)


@pytest.mark.slow
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_tiny_svd_loss_and_gradients_match_jax(impl):
    """``SVDUNetConfig.tiny`` (9 channels) at 128 px (16×16 latents: at 64
    px the deepest level is 1×1, where a GroupNorm over two values makes the
    gradients ill-conditioned), the port checkpointed: the loss and every
    UNet gradient against ``jax.value_and_grad`` of JAX's loss function
    (built without remat: JAX cannot remat interpret-mode Pallas kernels).
    The gradients that the tiny UNet's 32-channel GroupNorms (one channel
    a group) make zero by construction are fp32 noise on both sides, far
    under ``GRAD_ATOL``."""
    from animate_anything_tpu.train.svd_trainer import SVDTrainConfig as JaxTC

    from animate_anything_tpu_torch.train.svd_trainer import SVDTrainConfig, make_svd_loss_fn
    from animate_anything_tpu_torch.utils.convert import svd_unet_state_dict

    jm = jax_svd_models({})
    jcfg = JaxTC(motion_mask=True)
    batch = make_batch(1, res=128)
    key = keys_by_drop(jcfg)[0]
    grad_fn = jax.jit(jax.value_and_grad(jax_loss_fn(jm, jcfg, impl, {}), has_aux=True))
    with pltpu.force_tpu_interpret_mode():
        (_, want), want_g = grad_fn(jm["unet_params"], batch, key)
    unet, vae, ienc = port_svd_models(jm, {}, impl, gradient_checkpointing=True)
    _, got = make_svd_loss_fn(SVDTrainConfig(motion_mask=True), vae, ienc)(
        unet, {k: t(v) for k, v in batch.items()}, jax_draws(key, jcfg, batch))
    got["loss"].backward()
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=LOSS_RTOL)
    named = dict(unet.named_parameters())
    for name, w in svd_unet_state_dict(want_g).items():
        np.testing.assert_allclose(n(named[name].grad), n(w), atol=GRAD_ATOL, err_msg=name)
