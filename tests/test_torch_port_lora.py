"""The port's LoRA (``models/lora.py``) against the JAX package's, on the CPU.

- the targets: the flax paths and the ``down`` / ``up`` shapes of
  ``init_lora_params`` on the tiny UNet and the tiny CLIP text encoder equal
  JAX's, for every class name of ``_CLASS_NAME_PATTERNS``, with and without
  ``include_convs`` (both refuse alike where nothing matches);
- the merge: the tiny UNet (every dense and conv kernel adapted, α ≠ r,
  scale ≠ 1) and the tiny CLIP encoder forward with the merged weights
  against JAX's forward with ``merge_lora``'s, the same numpy-drawn adapter
  on both sides (5e-5 absolute, the tiny UNet tests' fp32 tolerance; the
  merged weights themselves within 1e-6), and a conv target's delta in the
  port's layout (3×3 and temporal);
- ``dropout_lora`` with JAX's keep masks: equal bit for bit;
- adapter files both ways (JAX ``save_lora`` → port ``load_lora`` and back),
  with the text encoder's prefix too: equal bit for bit;
- slow: ``make_lora_train_step`` against JAX's on the tiny UNet with UNet
  and text LoRA and rank dropout, JAX's draws fed to the port: the loss,
  every adapter gradient and one AdamW step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_tiny_models, load_into, n, t

ATOL = 5e-5
CLASS_NAMES = ("UNet3DConditionModel", "CLIPTextModel", "CLIPEncoderLayer", "CLIPAttention",
               "CrossAttention", "Attention", "Transformer2DModel", "TransformerTemporalModel",
               "ResnetBlock2D", "TemporalConvLayer", "GEGLU")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these many tiny CPU ops: beside the other
    test workers, a thread pool per op costs more than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_models():
    return jax_tiny_models()


@pytest.fixture(scope="module")
def port_models(jax_models):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.utils.convert import clip_text_state_dict, unet3d_state_dict

    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(
        motion_mask=True, motion_strength=True, attn_impl="xla")),
        unet3d_state_dict(jax_models["unet_params"]))
    text = load_into(CLIPTextModel(CLIPTextConfig.tiny(hidden_size=32)),
                     clip_text_state_dict(jax_models["text_params"]))
    return {"unet": unet, "text": text}


def _jax_init(params, cfg):
    from animate_anything_tpu.models.lora import init_lora_params

    try:
        return init_lora_params(jax.random.PRNGKey(0), params, cfg)
    except ValueError:
        return None


def _port_init(module, naming, cfg):
    from animate_anything_tpu_torch.models.lora import init_lora_params, lora_params

    try:
        return init_lora_params(torch.Generator().manual_seed(0), lora_params(module, naming), cfg)
    except ValueError:
        return None


def _shapes(lora):
    return None if lora is None else {p: (tuple(ab["down"].shape), tuple(ab["up"].shape))
                                      for p, ab in lora.items()}


@pytest.mark.parametrize("include_convs", [False, True], ids=["dense", "convs"])
@pytest.mark.parametrize("target", CLASS_NAMES)
def test_unet_targets_and_shapes_match_jax(jax_models, port_models, target, include_convs):
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu_torch.models.lora import LoraConfig

    want = _shapes(_jax_init(jax_models["unet_params"],
                             JaxCfg(rank=4, targets=(target,), include_convs=include_convs)))
    got = _shapes(_port_init(port_models["unet"], "unet",
                             LoraConfig(rank=4, targets=(target,), include_convs=include_convs)))
    assert got == want


@pytest.mark.parametrize("target", CLASS_NAMES)
def test_text_targets_and_shapes_match_jax(jax_models, port_models, target):
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu_torch.models.lora import LoraConfig

    want = _shapes(_jax_init(jax_models["text_params"], JaxCfg(rank=4, targets=(target,))))
    got = _shapes(_port_init(port_models["text"], "text", LoraConfig(rank=4, targets=(target,))))
    assert got == want


def test_every_dense_kernel_is_a_target_of_the_lora_yaml(port_models):
    """``UNet3DConditionModel`` without convs: every 2-d weight of the port's
    UNet, and nothing else (the 3×3 and temporal convs stay frozen)."""
    from animate_anything_tpu_torch.models.lora import LoraConfig, flax_names

    lora = _port_init(port_models["unet"], "unet", LoraConfig(targets=("UNet3DConditionModel",)))
    names = flax_names(port_models["unet"])
    params = dict(port_models["unet"].named_parameters())
    assert {names[p] for p in lora} == {k for k, v in params.items() if v.ndim == 2}


def test_init_draws_down_over_rank_and_zero_up():
    from animate_anything_tpu_torch.models.lora import LoraConfig, init_lora_params

    params = {"a.kernel": torch.zeros(64, 512)}
    a = init_lora_params(torch.Generator().manual_seed(7), params, LoraConfig(rank=8,
                                                                              targets=("a",)))
    b = init_lora_params(torch.Generator().manual_seed(7), params, LoraConfig(rank=8,
                                                                              targets=("a",)))
    assert a["a.kernel"]["down"].shape == (512, 8) and a["a.kernel"]["up"].shape == (8, 64)
    assert torch.equal(a["a.kernel"]["down"], b["a.kernel"]["down"])
    assert not a["a.kernel"]["up"].any()
    np.testing.assert_allclose(float(a["a.kernel"]["down"].std()), 1 / 8, rtol=0.05)


def _numpy_adapter(lora, seed):
    """Random down and up for every target of ``lora`` (numpy, float32)."""
    r = np.random.default_rng(seed)
    return {p: {"down": (0.1 * r.standard_normal(ab["down"].shape)).astype(np.float32),
                "up": (0.1 * r.standard_normal(ab["up"].shape)).astype(np.float32)}
            for p, ab in lora.items()}


def _torch_adapter(adapter):
    return {p: {k: t(v) for k, v in ab.items()} for p, ab in adapter.items()}


@pytest.fixture(scope="module")
def merged_unet(jax_models, port_models):
    """Every dense and conv kernel of the tiny UNet adapted (rank 4, α 8),
    merged on both sides."""
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu.models.lora import init_lora_params, merge_lora
    from animate_anything_tpu_torch.models import UNet3DConditionModel
    from animate_anything_tpu_torch.models.lora import LoraConfig, lora_params
    from animate_anything_tpu_torch.models.lora import merge_lora as port_merge

    kw = dict(rank=4, alpha=8.0, targets=("UNet3DConditionModel",), include_convs=True)
    adapter = _numpy_adapter(init_lora_params(jax.random.PRNGKey(0), jax_models["unet_params"],
                                              JaxCfg(**kw)), seed=3)
    want = merge_lora(jax_models["unet_params"], adapter, JaxCfg(**kw))
    unet = UNet3DConditionModel(port_models["unet"].config)
    unet.load_state_dict(port_models["unet"].state_dict())
    params = lora_params(unet)
    got = port_merge(params, _torch_adapter(adapter), LoraConfig(**kw))
    with torch.no_grad():
        for p, w in got.items():
            params[p].copy_(w)
    return want, unet.eval()


def test_merged_unet_weights_match_jax_in_the_port_layout(merged_unet):
    """The merged kernels, 3×3 convs and temporal convs included, carried
    through the exporter's key map: each delta was permuted into the port's
    layout."""
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    want, unet = merged_unet
    want_sd = unet3d_state_dict(want)
    got = unet.state_dict()
    for name in ("conv_in2.weight", "down_blocks.0.temp_convs.0.conv2.3.weight",
                 "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"):
        assert got[name].shape == want_sd[name].shape
    for name, w in want_sd.items():
        np.testing.assert_allclose(n(got[name]), n(w), atol=1e-6, err_msg=name)


def test_merged_unet_forward_matches_jax(jax_models, merged_unet):
    want_params, unet = merged_unet
    r = np.random.default_rng(1)
    b, f, hw = 1, 3, 8
    args = (r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), np.int32(400),
            r.standard_normal((b, 77, 32)).astype(np.float32),
            r.standard_normal((b, 1, hw, hw, 4)).astype(np.float32),
            (r.random((b, 1, hw, hw, 1)) > 0.5).astype(np.float32), np.array([3.0], np.float32))
    want = np.asarray(jax.jit(jax_models["unet"].apply)(want_params, *args))
    with torch.no_grad():
        got = unet(t(args[0]), 400, t(args[2]), t(args[3]), t(args[4]), t(args[5]))
    np.testing.assert_allclose(n(got), want, atol=ATOL)


def test_merged_text_forward_matches_jax(jax_models, port_models):
    """The CLIP encoder's adapter (``CLIPEncoderLayer``, rank 4) folded in by
    ``collapse_lora_`` against JAX's ``merge_lora``."""
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu.models.lora import init_lora_params, merge_lora
    from animate_anything_tpu_torch.models.clip_text import CLIPTextModel
    from animate_anything_tpu_torch.models.lora import LoraConfig, collapse_lora_

    adapter = _numpy_adapter(init_lora_params(jax.random.PRNGKey(0), jax_models["text_params"],
                                              JaxCfg(rank=4, targets=("CLIPEncoderLayer",))), 5)
    ids = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(np.int32)
    want = jax_models["text"].apply(merge_lora(
        jax_models["text_params"], adapter, JaxCfg(rank=4, targets=("CLIPEncoderLayer",)),
        stop_base_gradient=False), ids)
    text = CLIPTextModel(port_models["text"].config)
    text.load_state_dict(port_models["text"].state_dict())
    collapse_lora_(text, _torch_adapter(adapter), LoraConfig(rank=4,
                                                             targets=("CLIPEncoderLayer",)),
                   naming="text")
    with torch.no_grad():
        got = text.eval()(t(ids))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        base = port_models["text"](t(ids))
    assert float((got - base).abs().max()) > 1e-3


def test_substituted_weights_reach_the_forward_and_come_back(port_models):
    from animate_anything_tpu_torch.models.lora import substituted

    text = port_models["text"]
    name = "text_model.encoder.layers.0.mlp.fc1.weight"
    orig = dict(text.named_parameters())[name]
    ids = torch.zeros((1, 16), dtype=torch.int32)
    with torch.no_grad():
        base = text(ids)
        with substituted(text, {name: torch.zeros_like(orig)}):
            changed = text(ids)
            assert not dict(text.named_parameters())[name].any()
        again = text(ids)
    assert dict(text.named_parameters())[name] is orig
    assert float((changed - base).abs().max()) > 1e-4
    assert torch.equal(again, base)


def test_text_lora_refuses_cached_embeddings_and_steps_need_the_card():
    """As JAX's loss refuses a text-LoRA batch without token ids: cached
    embeddings would bypass the trained adapter."""
    from animate_anything_tpu_torch.diffusion.schedule import make_schedule
    from animate_anything_tpu_torch.models.lora import LoraConfig
    from animate_anything_tpu_torch.train import TrainConfig, make_lora_train_step, make_loss_fn

    loss_fn = make_loss_fn(make_schedule(), TrainConfig(), text_grad=True)
    batch = {"latents": torch.zeros(1, 2, 4, 4, 4), "mask": torch.zeros(1, 32, 32),
             "encoder_hidden_states": torch.zeros(1, 77, 32),
             "uncond_hidden_states": torch.zeros(1, 77, 32)}
    with pytest.raises(ValueError, match="token ids"):
        loss_fn(None, batch, torch.zeros(1, 2, 4, 4, 4), torch.zeros(1, dtype=torch.long), False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_lora_train_step(make_schedule(), TrainConfig(), None, {}, LoraConfig())


def _jax_keep_masks(rng, lora, cfg):
    """The keep masks JAX's ``dropout_lora`` draws from ``rng``."""
    keep = {}
    for p in sorted(lora):
        rng, sub = jax.random.split(rng)
        keep[p] = torch.from_numpy(np.array(jax.random.bernoulli(sub, 1.0 - cfg.dropout,
                                                                   (cfg.rank,))))
    return keep


def test_dropout_matches_jax_with_the_same_keep_masks(jax_models):
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu.models.lora import dropout_lora, init_lora_params
    from animate_anything_tpu_torch.models.lora import LoraConfig
    from animate_anything_tpu_torch.models.lora import dropout_lora as port_dropout

    jcfg = JaxCfg(rank=8, targets=("CrossAttention",), dropout=0.4)
    adapter = _numpy_adapter(init_lora_params(jax.random.PRNGKey(0), jax_models["unet_params"],
                                              jcfg), seed=9)
    key = jax.random.PRNGKey(4)
    want = dropout_lora(key, adapter, jcfg)
    keep = _jax_keep_masks(key, adapter, jcfg)
    cfg = LoraConfig(rank=8, targets=("CrossAttention",), dropout=0.4)
    got = port_dropout(_torch_adapter(adapter), cfg, keep=keep)
    assert set(got) == set(want)
    assert 0 < sum(int(k.sum()) for k in keep.values()) < 8 * len(keep)
    for p in want:
        for part in ("down", "up"):
            np.testing.assert_array_equal(n(got[p][part]), np.asarray(want[p][part]))
    drawn = port_dropout(_torch_adapter(adapter), cfg, torch.Generator().manual_seed(0))
    kept = [bool(drawn[p]["down"][0, i] != 0) for p in drawn for i in range(8)]
    assert 0 < sum(kept) < len(kept)


@pytest.mark.parametrize("prefix,model,target", [("unet", "unet_params", "CrossAttention"),
                                                 ("text_encoder", "text_params",
                                                  "CLIPEncoderLayer")])
def test_adapter_files_load_both_ways(jax_models, tmp_path, prefix, model, target):
    """JAX's file read by the port, the port's by JAX: the same keys,
    layouts, metadata and values."""
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu.models.lora import init_lora_params
    from animate_anything_tpu.models.lora import load_lora as jax_load
    from animate_anything_tpu.models.lora import save_lora as jax_save
    from animate_anything_tpu_torch.models.lora import LoraConfig, load_lora, save_lora

    jcfg = JaxCfg(rank=4, alpha=2.0, targets=(target,))
    adapter = _numpy_adapter(init_lora_params(jax.random.PRNGKey(0), jax_models[model], jcfg), 6)
    jax_save(str(tmp_path / "jax.safetensors"), adapter, jcfg, prefix=prefix)
    got, cfg = load_lora(str(tmp_path / "jax.safetensors"), prefix=prefix)
    assert cfg == LoraConfig(rank=4, alpha=2.0, targets=(target,))
    assert set(got) == set(adapter)
    for p, ab in adapter.items():
        for part in ("down", "up"):
            assert got[p][part].is_contiguous()
            np.testing.assert_array_equal(n(got[p][part]), ab[part])

    save_lora(str(tmp_path / "port.safetensors"), got, cfg, prefix=prefix)
    back, back_cfg = jax_load(str(tmp_path / "port.safetensors"), prefix=prefix)
    assert back_cfg == jcfg
    assert set(back) == set(adapter)
    for p, ab in adapter.items():
        for part in ("down", "up"):
            np.testing.assert_array_equal(back[p][part], ab[part])
    from safetensors import safe_open

    with safe_open(str(tmp_path / "port.safetensors"), "np") as a, \
            safe_open(str(tmp_path / "jax.safetensors"), "np") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        assert a.metadata() == b.metadata()


def _jax_lora_draws(key, batch, jcfg, jsched, lora_cfgs):
    """JAX's draws in its LoRA ``loss_fn``: the two adapters' keep masks,
    then the noise, t and the text-dropout flag."""
    from test_torch_port_trainer import _jax_draws

    rng, r_train = jax.random.split(key)
    r_u, r_t = jax.random.split(r_train)
    keeps = (_jax_keep_masks(r_u, *lora_cfgs[0]), _jax_keep_masks(r_t, *lora_cfgs[1]))
    return keeps, _jax_draws(key, batch["latents"].shape, jcfg, jsched)


@pytest.mark.slow
def test_lora_train_step_matches_jax():
    """UNet LoRA (every dense kernel, rank 4, dropout 0.25) and text LoRA
    (``CLIPEncoderLayer``, dropout 0.5) on the tiny mask+motion UNet and CLIP
    encoder, fp32, ``attn_impl="xla"`` (the flash backward has its own
    tests): the port's ``make_lora_train_step`` fed JAX's draws against
    JAX's jitted step. The gradients are read off one step of an identity
    optimizer, as ``test_torch_port_trainer.py`` reads them; then one step
    of each side's AdamW. Tolerances: loss 1e-5 relative, gradients 5e-5
    absolute; the adapters after AdamW within 1e-6 but at most one entry in
    a thousand, and every entry within lr/10 (lr 1e-3). The first step moves
    an entry by lr·g/(|g| + eps): ±lr where |g| ≫ eps, but where a gradient
    lies within a few eps = 1e-8 of 0 its fp32 noise moves the step by a
    share of lr (2.8e-5 read at one entry of 256 in a tensor)."""
    import optax

    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu.models.lora import LoraConfig as JaxCfg
    from animate_anything_tpu.models.lora import init_lora_params
    from animate_anything_tpu.train import TrainConfig as JaxConfig
    from animate_anything_tpu.train import create_train_state as jax_state
    from animate_anything_tpu.train import make_lora_train_step as jax_step
    from animate_anything_tpu.train.trainer import TrainState
    from animate_anything_tpu_torch.diffusion.schedule import make_schedule
    from animate_anything_tpu_torch.models import lora
    from animate_anything_tpu_torch.models.lora import LoraConfig, lora_params
    from animate_anything_tpu_torch.train import (TrainConfig, create_lora_train_state,
                                                  make_lora_train_step)
    from animate_anything_tpu_torch.train import trainer

    jm = jax_tiny_models()
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.utils.convert import clip_text_state_dict, unet3d_state_dict

    unet = load_into(UNet3DConditionModel(UNet3DConfig.tiny(
        motion_mask=True, motion_strength=True, attn_impl="xla", gradient_checkpointing=True)),
        unet3d_state_dict(jm["unet_params"]))
    text = load_into(CLIPTextModel(CLIPTextConfig.tiny(hidden_size=32)),
                     clip_text_state_dict(jm["text_params"]))
    for m in (unet, text):
        m.requires_grad_(False)
    ucfg = dict(rank=4, targets=("UNet3DConditionModel",), dropout=0.25)
    tcfg = dict(rank=4, targets=("CLIPEncoderLayer",), dropout=0.5)
    tree = {"unet_lora": _numpy_adapter(init_lora_params(jax.random.PRNGKey(0), jm["unet_params"],
                                                         JaxCfg(**ucfg)), 11),
            "text_lora": _numpy_adapter(init_lora_params(jax.random.PRNGKey(0), jm["text_params"],
                                                         JaxCfg(**tcfg)), 12)}
    r = np.random.default_rng(5)
    b, f, hw = 1, 3, 8
    mask = np.zeros((b, 8 * hw, 8 * hw), np.float32)
    mask[:, 16:48, 8:56] = 255.0
    batch = {"latents": r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), "mask": mask,
             "prompt_ids": r.integers(0, 64, (b, 16)).astype(np.int32),
             "uncond_ids": np.zeros((b, 16), np.int32)}
    kw = dict(motion_mask=True, motion_strength=True, learning_rate=1e-3)
    jcfg = JaxConfig(cache_latents=True, **kw)
    jsched = jax_schedule(prediction_type="v_prediction")
    step = jax_step(jm["unet"], jsched, jcfg, base_params=jm["unet_params"],
                    lora_config=JaxCfg(**ucfg), text_base_params=jm["text_params"],
                    text_lora_config=JaxCfg(**tcfg), text_encoder=jm["text"],
                    text_params=jm["text_params"])
    key = jax.random.PRNGKey(3)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    ident = TrainState(step=jnp.zeros((), jnp.int32), params=jtree, opt_state=(),
                       tx=optax.identity())
    new, want = jax.jit(step)(ident, jbatch, key)
    want_grads = jax.tree_util.tree_map(lambda a, c: np.asarray(a) - np.asarray(c),
                                        new.params, jtree)
    adam, _ = jax.jit(step)(jax_state(jtree, jcfg), jbatch, key)

    keeps, (noise, steps, drop) = _jax_lora_draws(
        key, batch, jcfg, jsched, ((tree["unet_lora"], JaxCfg(**ucfg)),
                                   (tree["text_lora"], JaxCfg(**tcfg))))
    ptree = {k: _torch_adapter(v) for k, v in tree.items()}
    state = create_lora_train_state(ptree, TrainConfig(**kw))
    ubase, tbase = lora_params(unet), lora_params(text, "text")
    fn = make_lora_train_step(
        make_schedule(prediction_type="v_prediction"), TrainConfig(**kw), unet,
        {p: ubase[p].detach() for p in ptree["unet_lora"]}, LoraConfig(**ucfg),
        text_encoder=text, text_base={p: tbase[p].detach() for p in ptree["text_lora"]},
        text_lora_config=LoraConfig(**tcfg), device="cpu")
    seen = {}

    def apply_and_read(state):
        seen.update({k: v.grad.clone() for k, v in state.masters.items()})
        return orig_apply(state)

    orig_apply = trainer.apply_gradients
    masks = list(keeps)
    orig_dropout = lora.dropout_lora

    def jax_dropout(tree, cfg, generator=None, keep=None):
        return orig_dropout(tree, cfg, keep=masks.pop(0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lora, "dropout_lora", jax_dropout)
        mp.setattr(trainer, "draw_inputs", lambda *a, **k: (noise, steps, drop))
        mp.setattr(trainer, "apply_gradients", apply_and_read)
        got = fn(state, {k: t(v) for k, v in batch.items()}, torch.Generator())
    assert not masks
    for k in ("loss", "mse_loss", "motion_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    errs = {"grad": 0.0, "adamw": 0.0}
    for part in ("unet_lora", "text_lora"):
        for p, ab in want_grads[part].items():
            for which in ("down", "up"):
                got_g = n(seen[f"{part}.{p}.{which}"])
                errs["grad"] = max(errs["grad"], float(np.abs(got_g - ab[which]).max()))
                np.testing.assert_allclose(got_g, ab[which], atol=ATOL,
                                           err_msg=f"{part}.{p}.{which}")
    off, total = 0, 0
    for part in ("unet_lora", "text_lora"):
        for p, ab in adam.params[part].items():
            for which in ("down", "up"):
                diff = np.abs(n(state.params[part][p][which]) - np.asarray(ab[which]))
                errs["adamw"] = max(errs["adamw"], float(diff.max()))
                off, total = off + int((diff > 1e-6).sum()), total + diff.size
                assert diff.max() <= 0.1 * 1e-3, f"{part}.{p}.{which}"
    assert off <= total // 1000, f"{off} of {total} adapter entries off by more than 1e-6"
    print(f"LoRA step against JAX: loss {got['loss']:.6g} / {float(want['loss']):.6g}, max "
          f"|gradient error| {errs['grad']:.3g}, max |adapter error| after AdamW "
          f"{errs['adamw']:.3g} ({off} of {total} entries above 1e-6)")
