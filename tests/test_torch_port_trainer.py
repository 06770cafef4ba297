"""The port's trainer against the JAX package's, on the CPU, in fp32.

- the diffusion targets (``get_velocity``, ``pred_epsilon``), the offset
  noise of ``sample_noise`` fed JAX's own normals, ``latent_motion_score``,
  ``motion_mask_loss`` and ``prepare_mask_for_latents``;
- the freeze labels: JAX's ``trainable_label_tree`` on the tiny UNet's flax
  paths against the port's on its diffusers names, carried through the
  exporter's key map (``utils/convert.py``), for the patterns the configs
  use;
- the optimizer against optax (``make_optimizer``: clip by global norm over
  the trainable leaves, AdamW, freezing, ``MultiSteps`` k = 2) over 3
  updates;
- one and two full train steps against ``make_train_step`` with a small
  flax denoiser (``tests/test_trainer.py``'s, timestep scaled) and its torch
  twin, JAX's rng splits reproduced here and their draws fed to the port's
  ``loss_fn``.

Tolerances: 1e-6 for the elementwise functions and the optimizer (fp32
rounding of the same formulas), 1e-5 for the train steps (loss, grad norm
and parameters; fp32 accumulation order through the toy's products).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_port_helpers import jax_params, n, t


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_schedule_targets_match_jax(prediction_type):
    from animate_anything_tpu.diffusion import schedule as jsched
    from animate_anything_tpu_torch.diffusion import schedule as psched

    r = np.random.default_rng(0)
    x0, noise, out = (r.standard_normal((2, 3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    steps = np.array([5, 998], np.int32)
    js = jsched.make_schedule(prediction_type=prediction_type, rescale_betas_zero_snr=False)
    ps = psched.make_schedule(prediction_type=prediction_type)
    np.testing.assert_allclose(n(psched.get_velocity(ps, t(x0), t(noise), t(steps))),
                               n(jsched.get_velocity(js, x0, noise, steps)), atol=1e-6)
    np.testing.assert_allclose(n(psched.pred_epsilon(ps, t(out), t(x0), t(steps))),
                               n(jsched.pred_epsilon(js, out, x0, steps)), atol=1e-5, rtol=1e-6)


def test_sample_noise_offset_matches_jax():
    from animate_anything_tpu.diffusion.schedule import sample_noise as jax_noise
    from animate_anything_tpu_torch.diffusion.schedule import sample_noise

    shape, key = (2, 3, 4, 4, 4), jax.random.PRNGKey(5)
    r1, r2 = jax.random.split(key)
    normals = (t(jax.random.normal(r1, shape)), t(jax.random.normal(r2, (2, 1, 1, 1, 4))))
    for strength in (0.0, 0.1):
        np.testing.assert_allclose(n(sample_noise(shape, strength, normals=normals)),
                                   n(jax_noise(key, shape, strength)), atol=1e-6)
    drawn = sample_noise(shape, 0.1, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == shape and drawn.dtype == torch.float32


def test_motion_metrics_and_mask_match_jax():
    from animate_anything_tpu.metrics import motion as jm
    from animate_anything_tpu.train.trainer import prepare_mask_for_latents as jax_mask
    from animate_anything_tpu_torch.metrics import motion as pm
    from animate_anything_tpu_torch.train import prepare_mask_for_latents

    r = np.random.default_rng(1)
    lat = r.standard_normal((2, 5, 6, 6, 4)).astype(np.float32)
    mask = (r.random((2, 1, 6, 6, 1)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(n(pm.latent_motion_score(t(lat))),
                               n(jm.latent_motion_score(lat)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(n(pm.motion_mask_loss(t(lat), t(mask))),
                               n(jm.motion_mask_loss(lat, mask)), atol=1e-6, rtol=1e-6)
    for hw, lat_hw in (((64, 64), (8, 8)), ((50, 36), (7, 5)), ((16, 16), (32, 32))):
        img = (r.random((2,) + hw) * 255.0).astype(np.float32)
        np.testing.assert_array_equal(n(prepare_mask_for_latents(t(img), *lat_hw)),
                                      n(jax_mask(img, *lat_hw)))


@pytest.fixture(scope="module")
def tiny_unet_params():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg

    r = np.random.default_rng(0)
    args = (r.standard_normal((1, 2, 8, 8, 4)).astype(np.float32), np.int32(1),
            r.standard_normal((1, 77, 32)).astype(np.float32),
            r.standard_normal((1, 1, 8, 8, 4)).astype(np.float32),
            np.ones((1, 1, 8, 8, 1), np.float32), np.ones((1,), np.float32))
    return jax_params(JaxUNet(JaxCfg.tiny(motion_mask=True, motion_strength=True)), *args)


@pytest.mark.parametrize("pattern", ["all", "conv_in", "temp_conv", "attn1", "attentions"])
def test_freeze_labels_match_jax(tiny_unet_params, pattern):
    """The same pattern freezes the same parameters on both sides: JAX's
    labels, exported through the key map, against the port's."""
    from animate_anything_tpu.train.trainer import trainable_label_tree as jax_labels
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.train import trainable_label_tree
    from animate_anything_tpu_torch.utils.convert import flax_path, unet3d_state_dict

    params = tiny_unet_params
    labels = jax_labels(params, (pattern,))
    codes = jax.tree_util.tree_map(lambda lab, p: np.full(p.shape, lab == "train", np.float32),
                                   labels, params)
    want = {k: bool(v.flatten()[0]) for k, v in unet3d_state_dict(codes).items()}
    paths = {".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(params)}

    model = UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True, motion_strength=True,
                                                        attn_impl="pallas"))
    got = trainable_label_tree(model, (pattern,))
    assert set(got) == set(want)
    assert {k: lab == "train" for k, lab in got.items()} == want
    assert {flax_path(k, p.ndim) for k, p in model.named_parameters()} == paths
    assert any(want.values())
    if pattern != "all":
        assert not all(want.values())


class _FlaxToy(flax.linen.Module):
    """``tests/test_trainer.py::_ToyDenoiser`` with the timestep scaled to
    [0, 1): the UNet's call signature, a few dense layers, outputs of unit
    scale (with raw t the outputs reach 1e2–1e3 and fp32 rounding of x̂0's
    frame differences alone moves the motion loss by 1e-5 relative)."""

    @flax.linen.compact
    def __call__(self, sample, t, embeds, cond, mask=None, motion=None, deterministic=True):
        nn_ = flax.linen
        b = sample.shape[0]
        x = jnp.concatenate([jnp.broadcast_to(cond, sample.shape), sample], -1)
        if mask is not None:
            x = jnp.concatenate([jnp.broadcast_to(mask, sample.shape[:-1] + (1,)), x], -1)
        x = nn_.Conv(8, (1, 1), name="conv_in")(x)
        steps = jnp.broadcast_to(t, (b,)).astype(jnp.float32)[:, None] / 1000.0
        emb = nn_.Dense(8, name="time_embedding")(steps)
        if motion is not None:
            emb = emb + nn_.Dense(8, name="motion_embedding")(motion[:, None].astype(jnp.float32))
        x = x + emb[:, None, None, None, :]
        x = x + nn_.Dense(8, name="mid_block")(embeds.mean(axis=1))[:, None, None, None, :]
        return nn_.Conv(sample.shape[-1], (1, 1), name="conv_out")(x)


class ToyDenoiser(nn.Module):
    """Torch twin of ``_FlaxToy``."""

    def __init__(self):
        super().__init__()
        self.conv_in = nn.Linear(9, 8)
        self.time_embedding = nn.Linear(1, 8)
        self.motion_embedding = nn.Linear(1, 8)
        self.mid_block = nn.Linear(32, 8)
        self.conv_out = nn.Linear(8, 4)

    def forward(self, sample, t, embeds, cond, mask=None, motion=None):
        b = sample.shape[0]
        x = torch.cat([cond.expand_as(sample), sample], -1)
        if mask is not None:
            x = torch.cat([mask.expand(*sample.shape[:-1], 1), x], -1)
        x = self.conv_in(x)
        emb = self.time_embedding(torch.as_tensor(t).expand(b).float()[:, None] / 1000.0)
        if motion is not None:
            emb = emb + self.motion_embedding(motion[:, None].float())
        x = x + emb[:, None, None, None, :]
        x = x + self.mid_block(embeds.mean(1))[:, None, None, None, :]
        return self.conv_out(x)


def _toy_state(params) -> dict:
    """The flax toy's params (or a tree shaped like them) in the twin's layout."""
    out = {}
    for name, leaf in params["params"].items():
        kernel = np.asarray(leaf["kernel"])
        out[name + ".weight"] = t(kernel.reshape(-1, kernel.shape[-1]).T.copy())
        out[name + ".bias"] = t(np.asarray(leaf["bias"]))
    return out


def _toy_setup(prediction_type="epsilon", **tc_kw):
    from animate_anything_tpu.diffusion import make_schedule
    from animate_anything_tpu.train import TrainConfig as JaxConfig
    from animate_anything_tpu_torch.train import TrainConfig

    b, f, hw = 2, 3, 16
    r = np.random.default_rng(7)
    mask = np.zeros((b, hw, hw), np.float32)
    mask[:, 4:12, 2:10] = 255.0
    batch = {"latents": r.standard_normal((b, f, hw // 8, hw // 8, 4)).astype(np.float32),
             "mask": mask,
             "encoder_hidden_states": r.standard_normal((b, 7, 32)).astype(np.float32),
             "uncond_hidden_states": np.zeros((b, 7, 32), np.float32)}
    lat = jnp.asarray(batch["latents"])
    unet = _FlaxToy()
    params = unet.init(jax.random.PRNGKey(2), lat, jnp.array(1), batch["encoder_hidden_states"],
                       lat[:, :1], jnp.ones((b, 1, hw // 8, hw // 8, 1)), jnp.ones((b,)))
    kw = dict(motion_mask=True, motion_strength=True, learning_rate=1e-3, **tc_kw)
    model = ToyDenoiser()
    model.load_state_dict(_toy_state(params))
    jsched = make_schedule(prediction_type=prediction_type,
                           rescale_betas_zero_snr=kw.get("rescale_schedule", False))
    return (unet, params, batch, model, JaxConfig(cache_latents=True, **kw), TrainConfig(**kw),
            jsched)


def test_optimizer_matches_optax_with_freezing_and_accumulation():
    from animate_anything_tpu.train.trainer import make_optimizer as jax_optimizer
    from animate_anything_tpu_torch.core.dtypes import master_params
    from animate_anything_tpu_torch.train import make_optimizer, trainable_label_tree

    _, params, _, model, jcfg, pcfg, _ = _toy_setup(
        trainable_modules=("conv_out", "time_embedding"), gradient_accumulation_steps=2,
        max_grad_norm=0.5, adam_weight_decay=0.1)
    tx = jax_optimizer(jcfg, params)
    opt_state = tx.init(params)
    labels = trainable_label_tree(model, pcfg.trainable_modules)
    assert {k for k, v in labels.items() if v == "train"} == {
        "conv_out.weight", "conv_out.bias", "time_embedding.weight", "time_embedding.bias"}
    masters = master_params(model, [k for k, v in labels.items() if v == "train"])
    opt = make_optimizer(pcfg, masters)
    r = np.random.default_rng(3)
    for micro in range(6):        # 3 updates of 2 micro-steps; clipping kicks in
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(r.standard_normal(p.shape).astype(np.float32) * 0.3), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tg = _toy_state(grads)
        changed = opt.step({k: tg[k] for k in masters}, masters)
        assert changed == (micro % 2 == 1)
        want = _toy_state(params)
        for k, m in masters.items():
            np.testing.assert_allclose(n(m), n(want[k]), atol=1e-6, err_msg=f"{k} @ {micro}")
        frozen = [k for k in want if k not in masters]
        for k in frozen:   # set_to_zero: untouched
            np.testing.assert_array_equal(n(want[k]), n(dict(model.named_parameters())[k]))


def _jax_draws(rng, latents_shape, config, schedule):
    """The random draws JAX's ``loss_fn`` makes from ``rng``."""
    from animate_anything_tpu.diffusion.schedule import sample_noise

    rng, _ = jax.random.split(rng)
    r_noise, r_t, r_drop = jax.random.split(rng, 3)
    use_offset = config.use_offset_noise and not config.rescale_schedule
    noise = sample_noise(r_noise, latents_shape,
                         config.offset_noise_strength if use_offset else 0.0)
    step = jax.random.randint(r_t, (latents_shape[0],), 0, schedule.num_train_timesteps)
    drop = jax.random.bernoulli(r_drop, config.text_dropout)
    return t(noise), t(step).long(), bool(drop)


@pytest.mark.parametrize("options", [dict(use_offset_noise=True),
                                     dict(rescale_schedule=True)],
                         ids=["offset-noise", "zero-snr"])
def test_train_steps_match_jax(options):
    """Under v-prediction, the objective the flagship's zero-SNR schedule
    needs (ε-prediction's x̂0 divides by sqrt(ᾱ_t), which is 0 at t = 999)."""
    from animate_anything_tpu.train import create_train_state as jax_state
    from animate_anything_tpu.train import make_train_step as jax_step
    from animate_anything_tpu_torch.diffusion.schedule import make_schedule
    from animate_anything_tpu_torch.train import create_train_state, make_loss_fn
    from animate_anything_tpu_torch.train.trainer import apply_gradients

    unet, params, batch, model, jcfg, pcfg, jsched = _toy_setup("v_prediction", **options)
    step_fn = jax.jit(jax_step(unet, jsched, jcfg))
    jstate = jax_state(params, jcfg)
    state = create_train_state(model, pcfg)
    loss_fn = make_loss_fn(make_schedule(prediction_type="v_prediction",
                                         rescale_betas_zero_snr=pcfg.rescale_schedule), pcfg)
    tbatch = {k: t(v) for k, v in batch.items()}
    for i, key in enumerate((jax.random.PRNGKey(0), jax.random.PRNGKey(11))):
        jstate, want = step_fn(jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
        noise, steps, drop = _jax_draws(key, batch["latents"].shape, jcfg, jsched)
        _, metrics = loss_fn(state.model, tbatch, noise, steps, drop)
        metrics["loss"].backward()
        got = {k: float(v.detach()) for k, v in metrics.items()}
        got["grad_norm"] = apply_gradients(state)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} @ step {i}")
        jparams = _toy_state(jstate.params)
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(n(p), n(jparams[name]), atol=1e-5,
                                       err_msg=f"{name} @ step {i}")
    assert state.step == 2


@pytest.mark.slow
def test_tiny_unet_loss_and_gradients_match_jax():
    """The flagship's loss and every gradient through the tiny mask+motion
    UNet, the port's with gradient checkpointing, against JAX's
    ``make_train_step`` (jitted, Pallas flash forward and backward in
    interpret mode; without remat, which cannot trace the interpreter's
    callbacks — remat does not change a gradient). JAX's gradients are read
    off one step of an identity optimizer (new params = params + grads).
    Slow: the JAX grad graph takes minutes to compile."""
    import optax
    from jax.experimental.pallas import tpu as pltpu

    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.train import TrainConfig as JaxConfig
    from animate_anything_tpu.train import make_train_step as jax_step
    from animate_anything_tpu.train.trainer import TrainState
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.train import make_loss_fn, mask_motion_finetune
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    r = np.random.default_rng(5)
    b, f, hw = 1, 2, 16
    mask = np.zeros((b, 8 * hw, 8 * hw), np.float32)
    mask[:, 32:96, 16:112] = 255.0
    batch = {"latents": r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), "mask": mask,
             "encoder_hidden_states": r.standard_normal((b, 77, 32)).astype(np.float32),
             "uncond_hidden_states": np.zeros((b, 77, 32), np.float32)}
    kw = dict(motion_mask=True, motion_strength=True)
    args = (batch["latents"], np.int32(1), batch["encoder_hidden_states"],
            batch["latents"][:, :1], np.ones((b, 1, hw, hw, 1), np.float32), np.ones((b,), np.float32))
    params = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **kw)), *args)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.02 * r.standard_normal(x.shape)).astype(np.float32)
        if "conv4" in str(p) and str(p[-1]) == "['kernel']" else x, params)
    config, schedule = mask_motion_finetune()
    jcfg = JaxConfig(learning_rate=config.learning_rate, adam_weight_decay=0.0,
                     rescale_schedule=True, cache_latents=True, **kw)
    jsched = jax_schedule(prediction_type="v_prediction", rescale_betas_zero_snr=True)
    unet = JaxUNet(JaxCfg.tiny(attn_impl="pallas", **kw))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=(),
                       tx=optax.identity())
    key = jax.random.PRNGKey(3)
    with pltpu.force_tpu_interpret_mode():
        new_state, want = jax.jit(jax_step(unet, jsched, jcfg))(
            state, jax.tree_util.tree_map(jnp.asarray, batch), key)
    want_grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                        new_state.params, params)

    model = UNet3DConditionModel(UNet3DConfig.tiny(gradient_checkpointing=True,
                                                        attn_impl="pallas", **kw))
    model.load_state_dict(unet3d_state_dict(params), strict=True)
    noise, steps, drop = _jax_draws(key, batch["latents"].shape, jcfg, jsched)
    loss, metrics = make_loss_fn(schedule, config)(model, {k: t(v) for k, v in batch.items()},
                                                   noise, steps, drop)
    loss.backward()
    for k in ("loss", "mse_loss", "motion_loss"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(want[k]), rtol=1e-5)
    grads = unet3d_state_dict(want_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p.grad), grads[name], atol=5e-5, err_msg=name)
