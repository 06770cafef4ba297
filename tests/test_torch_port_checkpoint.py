"""The port's checkpoint IO and model factory against the JAX package's, on
the CPU:

- ``load_state_dict`` on files written by ``safetensors.numpy`` (F32, F16,
  I64) and ``safetensors.torch`` (BF16), and ``save_pipeline``'s fp32
  files read by ``safetensors.numpy``: equal values back, exactly;
- a directory written by JAX's ``save_pipeline`` (tiny random weights) loads
  through the port's ``build_models(dir, device="cpu")`` into state dicts
  equal to ``utils/convert.py``'s export of the same JAX params (exactly),
  and the UNet (atol 5e-5, ``attn_impl="xla"``), VAE (5e-5) and CLIP text
  (1e-5) forwards match JAX's within the tiny tests' tolerances;
- a directory written by the port's ``save_pipeline`` loads through JAX's
  ``load_pipeline_components`` / ``build_models`` into the same params
  (exactly);
- the conv_in → conv_in2 surgery on a checkpoint without ``conv_in2``, the
  keys no forward reads;
- the ``*_config_from_json`` functions field by field and
  ``schedule_from_json`` with ``rescale`` True and False against JAX's;
- the tokenizer branches, and ``build_models`` refusing a missing card.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_tiny_models, n, save_jax_pipeline, t

UNET_ATOL, VAE_ATOL, CLIP_ATOL = 5e-5, 5e-5, 1e-5
MASK = dict(motion_mask=True, motion_strength=True)


# --------------------------------------------------------------------------
# safetensors
# --------------------------------------------------------------------------

def _arrays(dtype):
    r = np.random.default_rng(0)
    if dtype == np.int64:
        return {"w": r.integers(-2**40, 2**40, (3, 5)), "b": np.arange(7),
                "scalar": np.full((), -4, np.int64), "empty": np.zeros((0, 2), np.int64)}
    return {"w": r.standard_normal((3, 5)).astype(dtype), "b": r.standard_normal(7).astype(dtype),
            "scalar": np.ones((), dtype), "empty": np.zeros((0, 2), dtype)}


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64], ids=["F32", "F16", "I64"])
def test_load_state_dict_reads_safetensors_numpy_files(tmp_path, dtype):
    from safetensors.numpy import save_file

    from animate_anything_tpu_torch.utils.convert import load_state_dict

    arrays = _arrays(dtype)
    save_file(arrays, str(tmp_path / "model.safetensors"), metadata={"format": "np"})
    for got in (load_state_dict(str(tmp_path)), load_state_dict(str(tmp_path / "model.safetensors"))):
        assert set(got) == set(arrays)
        for name, want in arrays.items():
            assert got[name].numpy().dtype == want.dtype and got[name].shape == want.shape
            np.testing.assert_array_equal(got[name].numpy(), want)


def test_load_state_dict_reads_bf16(tmp_path):
    from safetensors.torch import save_file

    from animate_anything_tpu_torch.utils.convert import load_state_dict

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(4, 6, generator=g).bfloat16(), "s": torch.tensor(1.5).bfloat16()}
    save_file(tensors, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    got = load_state_dict(str(tmp_path))
    for name, want in tensors.items():
        assert got[name].dtype == torch.bfloat16 and torch.equal(got[name], want)


def test_save_pipeline_writes_fp32_whatever_the_module_runs_in(tmp_path):
    """A bf16 module's weights land as fp32 (exact upcasts) under diffusers
    names, readable by ``safetensors.numpy``; the bytes returned are the
    weight files' sizes."""
    from safetensors.numpy import load_file

    from animate_anything_tpu_torch.models.vae import VAEConfig
    from animate_anything_tpu_torch.train.checkpoint import save_pipeline

    unet = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.GroupNorm(2, 4)).bfloat16()
    vae = torch.nn.Linear(5, 2)
    nbytes = save_pipeline(str(tmp_path), unet, VAEConfig(), vae, VAEConfig())
    files = [tmp_path / "unet" / "diffusion_pytorch_model.safetensors",
             tmp_path / "vae" / "diffusion_pytorch_model.safetensors"]
    assert nbytes == sum(os.path.getsize(f) for f in files)
    assert not (tmp_path / "text_encoder").exists()
    for f, module in zip(files, (unet, vae)):
        got = load_file(str(f))
        want = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v.float().numpy())
    with open(tmp_path / "model_index.json") as f:
        assert json.load(f)["_class_name"] == "LatentToVideoPipeline"


# --------------------------------------------------------------------------
# pipeline directories, both ways
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_models():
    return jax_tiny_models()


@pytest.fixture(scope="module")
def jax_dir(jax_models, tmp_path_factory):
    return save_jax_pipeline(jax_models, tmp_path_factory.mktemp("jax_pipeline"))


@pytest.fixture(scope="module")
def port_from_jax_dir(jax_dir):
    from animate_anything_tpu_torch.models.factory import build_models

    with pytest.warns(UserWarning, match="tokenizer"):
        return build_models(jax_dir, model_size="tiny", device="cpu", **MASK)


def _exports(jm):
    from animate_anything_tpu_torch.utils.convert import (clip_text_state_dict,
                                                          unet3d_state_dict, vae_state_dict)

    return {"unet": unet3d_state_dict(jm["unet_params"]), "vae": vae_state_dict(jm["vae_params"]),
            "text": clip_text_state_dict(jm["text_params"])}


def test_jax_saved_directory_loads_into_the_port(jax_models, port_from_jax_dir):
    models = port_from_jax_dir
    for name, want in _exports(jax_models).items():
        got = models[name].state_dict()
        assert set(got) == set(want), name
        for k, v in want.items():
            assert got[k].dtype == torch.float32 and torch.equal(got[k], v), (name, k)
    assert models["unet_config"].block_out_channels == (32, 64, 64, 64)
    assert models["unet_config"].motion_mask and models["unet_config"].attn_impl is None
    assert models["text_config"].max_position_embeddings == 16
    assert not models["unet"].training


def test_jax_saved_directory_forwards_match_jax(jax_models, port_from_jax_dir):
    from animate_anything_tpu.models.vae import decode_video as jax_decode
    from animate_anything_tpu_torch.models.vae import decode_video

    jm, pm = jax_models, port_from_jax_dir
    r = np.random.default_rng(3)
    x = r.standard_normal((1, 2, 8, 8, 4)).astype(np.float32)
    ctx = r.standard_normal((1, 77, 32)).astype(np.float32)
    cond = r.standard_normal((1, 1, 8, 8, 4)).astype(np.float32)
    mask = (r.random((1, 1, 8, 8, 1)) > 0.5).astype(np.float32)
    motion = np.array([4.0], np.float32)
    ids = r.integers(0, 64, (2, 16)).astype(np.int32)
    want_u = jax.jit(jm["unet"].apply)(jm["unet_params"], x, np.int32(500), ctx, cond, mask,
                                       motion)
    want_v = jax_decode(jm["vae"], jm["vae_params"], x)
    want_t = jm["text"].apply(jm["text_params"], ids)
    with torch.no_grad():
        got_u = pm["unet"](t(x), 500, t(ctx), t(cond), t(mask), t(motion))
        got_v = decode_video(pm["vae"], t(x))
        got_t = pm["text"](t(ids))
    np.testing.assert_allclose(n(got_u), np.asarray(want_u), atol=UNET_ATOL)
    np.testing.assert_allclose(n(got_v), np.asarray(want_v), atol=VAE_ATOL)
    np.testing.assert_allclose(n(got_t), np.asarray(want_t), atol=CLIP_ATOL)


def _assert_same_tree(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert {p for p, _ in flat_g} == set(flat_w)
    for p, v in flat_g:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(flat_w[p]), err_msg=str(p))


def test_port_saved_directory_loads_into_jax(jax_models, port_from_jax_dir, tmp_path):
    from animate_anything_tpu.models.factory import build_models as jax_build
    from animate_anything_tpu.train.checkpoint import load_pipeline_components
    from animate_anything_tpu_torch.train.checkpoint import save_pipeline

    pm = port_from_jax_dir
    nbytes = save_pipeline(str(tmp_path), pm["unet"], pm["unet_config"], pm["vae"],
                           pm["vae_config"], pm["text"], pm["text_config"])
    sizes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp_path)
                for f in fs if f.endswith(".safetensors"))
    assert nbytes == sizes
    comp = load_pipeline_components(str(tmp_path))
    assert {"unet", "vae", "text_encoder", "unet_config", "vae_config", "text_config"} <= set(comp)
    with pytest.warns(UserWarning, match="tokenizer"):
        loaded = jax_build(str(tmp_path), model_size="tiny", **MASK)
    jm = jax_models
    _assert_same_tree(loaded["unet_params"]["params"], jm["unet_params"]["params"])
    _assert_same_tree(loaded["vae_params"]["params"], jm["vae_params"]["params"])
    _assert_same_tree(loaded["text_params"]["params"], jm["text_params"]["params"])
    assert loaded["unet_config"].block_out_channels == jm["unet_config"].block_out_channels
    with open(tmp_path / "model_index.json") as f:
        assert json.load(f)["_class_name"] == "LatentToVideoPipeline"


def test_conv_in_surgery_on_a_checkpoint_without_the_mask_channel(tmp_path):
    """A UNet saved without the mask (``conv_in``, 4 channels) loads into the
    mask UNet with ``conv_in2`` = a zero input channel in front of
    ``conv_in``'s kernel and its bias, on both sides, and the two forwards
    agree."""
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models.factory import build_models as jax_build
    from animate_anything_tpu_torch.models.factory import build_models
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    plain = jax_tiny_models(motion_mask=False)
    path = save_jax_pipeline(plain, tmp_path / "plain")
    src = unet3d_state_dict(plain["unet_params"])
    assert "conv_in2.weight" not in src
    with pytest.warns(UserWarning):
        port = build_models(path, model_size="tiny", device="cpu", **MASK)
        jax_side = jax_build(path, model_size="tiny", **MASK)
    w = port["unet"].state_dict()["conv_in2.weight"]
    assert w.shape == (32, 5, 3, 3)
    assert torch.equal(w[:, 0], torch.zeros_like(w[:, 0]))
    assert torch.equal(w[:, 1:], src["conv_in.weight"])
    assert torch.equal(port["unet"].state_dict()["conv_in2.bias"], src["conv_in.bias"])
    assert "conv_in.weight" not in port["unet"].state_dict()
    want_sd = unet3d_state_dict(jax_side["unet_params"])
    for k, v in port["unet"].state_dict().items():
        assert torch.equal(v, want_sd[k]), k

    r = np.random.default_rng(5)
    x = r.standard_normal((1, 2, 8, 8, 4)).astype(np.float32)
    ctx = r.standard_normal((1, 77, 32)).astype(np.float32)
    cond = r.standard_normal((1, 1, 8, 8, 4)).astype(np.float32)
    mask = (r.random((1, 1, 8, 8, 1)) > 0.5).astype(np.float32)
    motion = np.array([4.0], np.float32)
    want = JaxUNet(jax_side["unet_config"]).apply(jax_side["unet_params"], x, np.int32(300), ctx,
                                                  cond, mask, motion)
    with torch.no_grad():
        got = port["unet"](t(x), 300, t(ctx), t(cond), t(mask), t(motion))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=UNET_ATOL)


def test_checkpoint_state_dict_drops_unused_keys():
    from animate_anything_tpu_torch.utils.convert import checkpoint_state_dict

    w = torch.ones(2, 2)
    unet = checkpoint_state_dict("unet", {"motion_embedding.0.weight": w,
                                          "motion_proj.linear_1.bias": w[0],
                                          "a.to_out.1.weight": w, "conv_in.weight": w,
                                          "conv_in2.weight": w, "keep.weight": w},
                                 motion_mask=True)
    assert set(unet) == {"conv_in2.weight", "keep.weight"}
    plain = checkpoint_state_dict("unet", {"conv_in.weight": w, "conv_in2.weight": w})
    assert set(plain) == {"conv_in.weight"}
    text = checkpoint_state_dict("text_encoder", {
        "text_model.embeddings.position_ids": w, "position_ids": w, "text_projection.weight": w,
        "logit_scale": w[0], "text_model.final_layer_norm.weight": w[0]})
    assert set(text) == {"text_model.final_layer_norm.weight"}
    vae = {"encoder.mid_block.attentions.0.to_q.weight": w}
    assert checkpoint_state_dict("vae", vae) == vae


def test_load_state_dict_file_names_and_bin(tmp_path):
    from safetensors.torch import save_file

    from animate_anything_tpu_torch.utils.convert import WEIGHT_NAMES, load_state_dict

    sd = {"a.weight": torch.randn(2, 3), "b": torch.arange(3)}
    torch.save({"state_dict": sd}, tmp_path / "pytorch_model.bin")
    got = load_state_dict(str(tmp_path))
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    save_file({"a.weight": torch.zeros(2, 3)}, str(tmp_path / "model.safetensors"))
    assert torch.equal(load_state_dict(str(tmp_path))["a.weight"], torch.zeros(2, 3))
    assert WEIGHT_NAMES.index("model.safetensors") < WEIGHT_NAMES.index("pytorch_model.bin")
    with pytest.raises(FileNotFoundError):
        load_state_dict(str(tmp_path / "missing_dir_is_a_file"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_state_dict(str(tmp_path / "empty"))


# --------------------------------------------------------------------------
# configs, schedule, tokenizer, device
# --------------------------------------------------------------------------

DIFFUSERS_UNET = {"_class_name": "UNet3DConditionModel", "act_fn": "silu",
                  "attention_head_dim": [64, 64, 64, 64], "block_out_channels": [320, 640, 1280, 1280],
                  "cross_attention_dim": 1024, "down_block_types": ["CrossAttnDownBlock3D"] * 3 +
                  ["DownBlock3D"], "in_channels": 4, "layers_per_block": 2, "norm_eps": 1e-05,
                  "norm_num_groups": 32, "out_channels": 4, "sample_size": 64,
                  "up_block_types": ["UpBlock3D"] + ["CrossAttnUpBlock3D"] * 3}


@pytest.mark.parametrize("cfg", [DIFFUSERS_UNET, {"block_out_channels": [32, 64, 64, 64],
                                                  "attention_head_dim": 8, "norm_num_groups": 8,
                                                  "cross_attention_dim": 32, "motion_mask": True,
                                                  "attn_impl": "pallas", "condition_mode":
                                                  "frame_concat"}, {}],
                         ids=["diffusers", "dump", "empty"])
def test_unet_config_from_json_matches_jax(cfg):
    import dataclasses

    from animate_anything_tpu.models.factory import unet_config_from_json as jax_fn
    from animate_anything_tpu_torch.models.factory import unet_config_from_json

    for over in ({}, dict(attn_impl="pallas", motion_mask=True, motion_strength=True)):
        got, want = unet_config_from_json(cfg, **over), jax_fn(cfg, **over)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_unet_config_from_json_refuses_the_channel_concat_condition():
    """The channel concat is ported: a config that names it reads as JAX's;
    a condition mode neither package has is refused."""
    import dataclasses

    from animate_anything_tpu.models.factory import unet_config_from_json as jax_fn
    from animate_anything_tpu_torch.models.factory import unet_config_from_json

    cfg = {"condition_mode": "channel_concat", "in_channels": 4, "motion_mask": True}
    got, want = unet_config_from_json(cfg), jax_fn(cfg)
    assert got.condition_mode == "channel_concat"
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    with pytest.raises(ValueError, match="condition_mode"):
        unet_config_from_json({"condition_mode": "bogus"})


@pytest.mark.parametrize("cfg", [{"_class_name": "AutoencoderKL", "block_out_channels":
                                  [128, 256, 512, 512], "latent_channels": 4, "sample_size": 512,
                                  "scaling_factor": 0.18215, "norm_num_groups": 32},
                                 {"block_out_channels": [16, 32, 32, 32], "norm_num_groups": 4},
                                 {}], ids=["diffusers", "dump", "empty"])
def test_vae_config_from_json_matches_jax(cfg):
    import dataclasses

    from animate_anything_tpu.models.factory import vae_config_from_json as jax_fn
    from animate_anything_tpu_torch.models.factory import vae_config_from_json

    got, want = vae_config_from_json(cfg), jax_fn(cfg)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("cfg", [{"architectures": ["CLIPTextModel"], "hidden_size": 1024,
                                  "num_hidden_layers": 23, "num_attention_heads": 16,
                                  "intermediate_size": 4096, "hidden_act": "gelu",
                                  "vocab_size": 49408, "max_position_embeddings": 77},
                                 {"vocab_size": 64, "hidden_size": 32, "num_layers": 2,
                                  "num_heads": 2, "intermediate_size": 64,
                                  "max_position_embeddings": 16, "hidden_act": "quick_gelu"},
                                 {}], ids=["hf", "dump", "empty"])
def test_clip_config_from_json_matches_jax(cfg):
    import dataclasses

    from animate_anything_tpu.models.factory import clip_config_from_json as jax_fn
    from animate_anything_tpu_torch.models.factory import clip_config_from_json

    got, want = clip_config_from_json(cfg), jax_fn(cfg)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("cfg", [{}, {"num_train_timesteps": 1000, "beta_schedule": "linear",
                                      "beta_start": 0.0001, "beta_end": 0.02,
                                      "prediction_type": "v_prediction"}],
                         ids=["defaults", "linear_v"])
def test_schedule_from_json_matches_jax(cfg, rescale):
    from animate_anything_tpu.models.factory import schedule_from_json as jax_fn
    from animate_anything_tpu_torch.models.factory import schedule_from_json

    got, want = schedule_from_json(cfg, rescale=rescale), jax_fn(cfg, rescale=rescale)
    assert got.num_train_timesteps == want.num_train_timesteps
    assert got.prediction_type == want.prediction_type
    np.testing.assert_allclose(n(got.betas), np.asarray(want.betas), rtol=1e-6, atol=0)
    np.testing.assert_allclose(n(got.alphas_cumprod), np.asarray(want.alphas_cumprod),
                               rtol=1e-6, atol=1e-12)
    assert (float(got.alphas_cumprod[-1]) < 1e-6) == rescale


def test_tokenizer_branches_match_jax(jax_dir, tmp_path, monkeypatch):
    """No directory: the hash tokenizer, no warning; a checkpoint without
    ``tokenizer/``: the hash tokenizer with a warning; a ``tokenizer/``
    directory: the BPE tokenizer, ids equal to JAX's; a broken one: an
    error, or the hash tokenizer under ``AA_ALLOW_HASH_TOKENIZER=1``."""
    import warnings

    from test_tokenizer import _write_assets

    from animate_anything_tpu.models.factory import build_models as jax_build
    from animate_anything_tpu_torch.models.clip_tokenizer import CLIPBPETokenizer
    from animate_anything_tpu_torch.models.factory import build_models
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fresh = build_models(None, model_size="tiny", device="cpu", **MASK)
    assert isinstance(fresh["tokenizer"], HashTokenizer)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        assert isinstance(build_models(jax_dir, model_size="tiny", device="cpu",
                                       **MASK)["tokenizer"], HashTokenizer)

    ckpt = tmp_path / "ckpt"
    shutil.copytree(jax_dir, ckpt)
    (ckpt / "tokenizer").mkdir()
    _write_assets(ckpt / "tokenizer")
    got = build_models(str(ckpt), model_size="tiny", device="cpu", **MASK)["tokenizer"]
    want = jax_build(str(ckpt), model_size="tiny", **MASK)["tokenizer"]
    assert isinstance(got, CLIPBPETokenizer)
    texts = ["hello world", "a red ball"]
    np.testing.assert_array_equal(got(texts, padding="max_length", max_length=16).input_ids,
                                  want(texts, padding="max_length", max_length=16).input_ids)

    (ckpt / "tokenizer" / "vocab.json").write_text("{not json")
    with pytest.raises(RuntimeError, match="tokenizer"):
        build_models(str(ckpt), model_size="tiny", device="cpu", **MASK)
    monkeypatch.setenv("AA_ALLOW_HASH_TOKENIZER", "1")
    assert isinstance(build_models(str(ckpt), model_size="tiny", device="cpu",
                                   **MASK)["tokenizer"], HashTokenizer)


def test_build_models_random_weights_and_dtypes():
    """No directory: the flax initialisers under generators seeded seed,
    seed + 1, seed + 2 (the same weights on a second build, others under
    another seed); bf16 casts matrices and keeps vectors fp32."""
    from animate_anything_tpu_torch.models.factory import build_models

    a = build_models(None, model_size="tiny", device="cpu", **MASK)
    b = build_models(None, model_size="tiny", device="cpu", **MASK)
    c = build_models(None, model_size="tiny", device="cpu", seed=1, **MASK)
    for name in ("unet", "vae", "text"):
        sa, sb, sc = (m[name].state_dict() for m in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    # the VAE of seed 0 is drawn from seed + 1 = 1, as the UNet of seed 1
    key = "conv_in2.weight"
    assert not torch.equal(a["unet"].state_dict()[key], c["unet"].state_dict()[key])
    half = build_models(None, model_size="tiny", device="cpu", compute_dtype=torch.bfloat16,
                        **MASK)
    for p in half["unet"].parameters():
        assert p.dtype == (torch.bfloat16 if p.ndim >= 2 else torch.float32)
    with pytest.raises(ValueError, match="compute_dtype"):
        build_models(None, model_size="tiny", device="cpu", compute_dtype=torch.float16)


def test_build_models_needs_the_card_unless_asked_for_the_cpu():
    from animate_anything_tpu_torch.models.factory import build_models

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_models(None, model_size="tiny", **MASK)
