"""The port's training entry point (``cli.main``, ``cli`` without
``--eval``, ``train_lora``) against the JAX package's, on the CPU, at
``configs/tiny_smoke.yaml`` (tiny models, fp32) on synthetic gifs:

- the run directory: ``config.yaml``, ``train_log.jsonl``, ``ckpt/step_*``
  and ``pipeline_step_N/`` under JAX's names, the pipeline read back by
  JAX's ``load_pipeline_components`` as the trained fp32 masters;
- resume from ``ckpt/`` at the saved step with the saved state, and the
  newest three checkpoints kept;
- a UNet + text LoRA run whose adapter files JAX's ``load_lora`` reads, with
  JAX's targets;
- (``main_eval`` with a JAX-saved adapter: ``test_torch_port_lora_eval.py``);
- the command lines ``chip_smoke.py`` runs: each YAML as ``load_config``
  reads it (equal to JAX's), changed only in the keys the phase names;
- the ε + zero-terminal-SNR quirk of ``configs/train_mask_motion.yaml``:
  t = 999 gives a non-finite motion loss on both sides;
- slow: JAX's ``main`` against the port's for 2 LoRA steps from the same
  weights, adapter init and draws: the losses (1e-5 relative) and the saved
  adapters (1e-6 at all but one entry in a thousand, lr/10 everywhere).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_torch_port_helpers import jax_tiny_models, n, save_jax_pipeline, t

CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "tiny_smoke.yaml")
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
LR = 1e-4        # tiny_smoke.yaml's learning_rate


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these many tiny CPU ops: beside the other
    test workers, a thread pool per op costs more than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gifs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gifs")
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        base = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        frames = []
        for i in range(6):
            fr = base.copy()
            fr[4:12, (2 + 3 * i):(8 + 3 * i)] = [255, 0, 0]
            frames.append(Image.fromarray(fr))
        frames[0].save(d / f"{name}.gif", save_all=True, append_images=frames[1:],
                       duration=100, loop=0)
    return str(d)


def _cfg(gifs, out, *extra):
    from animate_anything_tpu_torch.core.config import load_config

    return load_config(CONFIG, [f"train_data.path={gifs}", f"output_dir={out}",
                                *extra]).to_dict()


def _log(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tree(root):
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


@pytest.fixture(scope="module")
def full_run(gifs, tmp_path_factory):
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.train import trainer

    seen = {}
    orig = trainer.apply_gradients

    def keep(state):
        seen["state"] = state
        return orig(state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "apply_gradients", keep)
        run_dir = cli.main(device="cpu", **_cfg(gifs, tmp_path_factory.mktemp("full")))
    return run_dir, seen["state"]


def test_main_writes_jax_run_directory_layout(full_run, gifs):
    run_dir, state = full_run
    files = {f for f in _tree(run_dir) if not f.startswith("tb" + os.sep)}
    assert files == {
        "config.yaml", "train_log.jsonl", "ckpt/step_00000002/train_state.pt",
        "pipeline_step_2/model_index.json", "pipeline_step_2/unet/config.json",
        "pipeline_step_2/unet/diffusion_pytorch_model.safetensors",
        "pipeline_step_2/vae/config.json",
        "pipeline_step_2/vae/diffusion_pytorch_model.safetensors",
        "pipeline_step_2/text_encoder/config.json",
        "pipeline_step_2/text_encoder/model.safetensors"}
    with open(os.path.join(run_dir, "config.yaml")) as f:
        assert yaml.safe_load(f) == _cfg(gifs, os.path.dirname(run_dir))
    log = _log(run_dir)
    assert [r["step"] for r in log] == [1, 2]
    for r in log:
        assert set(r) == {"step", "time", "loss", "mse_loss", "motion_loss", "grad_norm"}
        assert all(np.isfinite(v) for v in r.values())
    assert state.step == 2


def test_the_pipeline_jax_reads_holds_the_trained_masters(full_run):
    from animate_anything_tpu.train.checkpoint import load_pipeline_components
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    run_dir, state = full_run
    comp = load_pipeline_components(os.path.join(run_dir, "pipeline_step_2"))
    assert {"unet", "vae", "text_encoder", "unet_config"} <= set(comp)
    got = unet3d_state_dict(comp["unet"])
    assert set(state.masters) <= set(got)
    for name, m in state.masters.items():
        np.testing.assert_array_equal(n(got[name]), n(m), err_msg=name)


def test_the_pipeline_keeps_the_fp32_weights_the_bf16_cast_rounds(gifs, tmp_path):
    """A bf16 run from a JAX-saved pipeline with only ``attn1`` trained: the
    VAE, the text encoder and the frozen UNet weights of the pipeline it
    writes equal, bit for bit, those JAX's ``save_pipeline`` wrote (JAX's
    ``main`` writes its fp32 parameters unchanged); the trained ones are the
    fp32 masters."""
    from animate_anything_tpu.train.checkpoint import load_pipeline_components
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.train import trainer
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    pipe = save_jax_pipeline(jax_tiny_models(), tmp_path / "pipeline")
    seen = {}
    orig = trainer.apply_gradients

    def keep(state):
        seen["state"] = state
        return orig(state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "apply_gradients", keep)
        with pytest.warns(UserWarning, match="tokenizer"):
            run_dir = cli.main(device="cpu", **_cfg(
                gifs, tmp_path / "run", f"pretrained_model_path={pipe}", "mixed_precision=bf16",
                "trainable_modules=[attn1]", "max_train_steps=1", "checkpointing_steps=1"))
    masters = seen["state"].masters
    src = load_pipeline_components(pipe)
    got = load_pipeline_components(os.path.join(run_dir, "pipeline_step_1"))
    for key in ("vae", "text_encoder"):
        want_leaves = jax.tree_util.tree_leaves_with_path(src[key])
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(got[key]))
        assert len(got_leaves) == len(want_leaves)
        for path, w in want_leaves:
            np.testing.assert_array_equal(np.asarray(got_leaves[path]), np.asarray(w),
                                          err_msg=f"{key} {jax.tree_util.keystr(path)}")
    want_unet, got_unet = unet3d_state_dict(src["unet"]), unet3d_state_dict(got["unet"])
    assert set(got_unet) == set(want_unet)
    frozen = set(want_unet) - set(masters)
    assert masters and frozen and all("attn1" in name for name in masters)
    for name in frozen:
        np.testing.assert_array_equal(n(got_unet[name]), n(want_unet[name]), err_msg=name)
    for name, m in masters.items():
        np.testing.assert_array_equal(n(got_unet[name]), n(m), err_msg=name)


def test_resume_restores_the_saved_state_and_continues(full_run, gifs, tmp_path):
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.train import checkpoint

    run_dir, state = full_run
    seen = []
    orig = checkpoint.restore_checkpoint

    def restored(path, st):
        out = orig(path, st)
        seen.append(({k: v.clone() for k, v in out.masters.items()}, out.step,
                     {k: v.clone() for k, v in out.optimizer.mu.items()}))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "restore_checkpoint", restored)
        run2 = cli.main(device="cpu", **_cfg(
            gifs, tmp_path, f"resume_from_checkpoint={os.path.join(run_dir, 'ckpt')}",
            "max_train_steps=4", "save_pretrained_model=false"))
    (masters, step, mu), = seen
    assert step == 2
    for k, v in state.masters.items():
        assert torch.equal(masters[k], v), k
        assert torch.equal(mu[k], state.optimizer.mu[k]), k
    assert [r["step"] for r in _log(run2)] == [3, 4]
    assert sorted(os.listdir(os.path.join(run2, "ckpt"))) == ["step_00000004"]


def test_checkpoints_keep_the_newest_three(gifs, tmp_path):
    from animate_anything_tpu_torch import cli

    run = cli.main(device="cpu", **_cfg(gifs, tmp_path, "max_train_steps=4",
                                        "checkpointing_steps=1",
                                        "save_pretrained_model=false"))
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "step_00000002", "step_00000003", "step_00000004"]
    assert not glob.glob(os.path.join(run, "pipeline_step_*"))


def test_cache_latents_trains_from_the_cache_jax_reads(gifs, tmp_path):
    """``cache_latents``: every clip encoded once into ``cached_latents/``
    (JAX's npz items, read by JAX's ``CachedDataset``), then trained from."""
    from animate_anything_tpu.data import CachedDataset as JaxCached
    from animate_anything_tpu_torch import cli

    run = cli.main(device="cpu", **_cfg(gifs, tmp_path, "cache_latents=true",
                                        "max_train_steps=1", "save_pretrained_model=false"))
    cached = JaxCached(cache_dir=os.path.join(run, "cached_latents"))
    assert len(cached) == 2
    item = cached[0]
    assert set(item) == {"latents", "mask", "prompt_ids"}
    assert item["latents"].shape == (4, 4, 4, 4) and np.isfinite(item["latents"]).all()
    assert [r["step"] for r in _log(run)] == [1]


def test_training_needs_the_card_or_one_device(gifs, tmp_path):
    from animate_anything_tpu_torch import cli

    with pytest.raises(ValueError, match="queue F"):
        cli.main(device="cpu", **_cfg(gifs, tmp_path / "a", "mesh.data=2"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(**_cfg(gifs, tmp_path / "b"))
    assert not os.path.exists(tmp_path / "a") and not os.path.exists(tmp_path / "b")


@pytest.fixture(scope="module")
def lora_run(gifs, tmp_path_factory):
    from animate_anything_tpu_torch.train_lora import train_lora

    out = tmp_path_factory.mktemp("lora")
    train_lora(["--config", CONFIG, "--device", "cpu", f"train_data.path={gifs}",
                f"output_dir={out}", "use_text_lora=true", "lora_rank=4",
                "unet_lora_modules=[CrossAttention]"])
    run, = glob.glob(os.path.join(out, "*"))
    return run


def test_lora_run_writes_adapters_jax_reads(lora_run):
    from animate_anything_tpu.models.lora import init_lora_params
    from animate_anything_tpu.models.lora import load_lora as jax_load

    files = _tree(lora_run)
    assert {"lora_step_2.safetensors", "lora_step_2.text_encoder.safetensors",
            "ckpt/step_00000002/train_state.pt", "config.yaml", "train_log.jsonl"} <= files
    assert not any(f.startswith("pipeline_step") for f in files)
    assert [r["step"] for r in _log(lora_run)] == [1, 2]
    jm = jax_tiny_models()
    for name, prefix, params in (("lora_step_2.safetensors", "unet", jm["unet_params"]),
                                 ("lora_step_2.text_encoder.safetensors", "text_encoder",
                                  jm["text_params"])):
        lora, cfg = jax_load(os.path.join(lora_run, name), prefix=prefix)
        assert cfg.rank == 4
        want = init_lora_params(jax.random.PRNGKey(0), params, cfg)
        assert set(lora) == set(want)
        for p, ab in lora.items():
            assert ab["down"].shape == want[p]["down"].shape
            assert ab["up"].shape == want[p]["up"].shape
        assert any(np.abs(ab["up"]).max() > 0 for ab in lora.values())


def test_lora_resume_continues_the_adapter(lora_run, gifs, tmp_path):
    from animate_anything_tpu_torch.train_lora import train_lora

    train_lora(["--config", CONFIG, "--device", "cpu", f"train_data.path={gifs}",
                f"output_dir={tmp_path}", "use_text_lora=true", "lora_rank=4",
                "unet_lora_modules=[CrossAttention]", "max_train_steps=3",
                f"resume_from_checkpoint={os.path.join(lora_run, 'ckpt')}"])
    run, = glob.glob(os.path.join(tmp_path, "*"))
    assert [r["step"] for r in _log(run)] == [3]
    assert os.path.isfile(os.path.join(run, "lora_step_3.text_encoder.safetensors"))


def test_chip_smoke_runs_the_yamls_as_load_config_reads_them():
    """Each YAML the card run trains at, read by the port's ``load_config``
    as JAX's reads it, and the phase's command lines changing only the data
    path, ``attn_impl``, the batch, the step counts and the directories."""
    import sys

    from animate_anything_tpu.core.config import load_config as jax_load
    from animate_anything_tpu_torch.core.config import load_config

    sys.path.insert(0, ROOT)
    import chip_smoke

    allowed = {"train_data", "attn_impl", "train_batch_size", "output_dir"}
    for path, argv in ((chip_smoke.TRAIN_LORA_CONFIG_PATH, chip_smoke.lora_entry_argv("x.json")),
                       (chip_smoke.TRAIN_FULL_CONFIG_PATH,
                        chip_smoke.full_entry_argv("y.json"))):
        path = os.path.join(ROOT, path)
        assert argv[:2] == ["--config", os.path.relpath(path, ROOT)]
        yaml_cfg = load_config(path).to_dict()
        assert yaml_cfg == jax_load(path).to_dict()
        run = load_config(path, argv[2:]).to_dict()
        changed = {k for k in set(run) | set(yaml_cfg) if run.get(k) != yaml_cfg.get(k)}
        assert changed <= allowed, changed
        assert {k: v for k, v in run["train_data"].items() if k != "json_path"} == \
            {k: v for k, v in yaml_cfg["train_data"].items() if k != "json_path"}
    assert chip_smoke.FULL_BATCH in (1, 2, 4, 8)
    assert chip_smoke.TRAIN_CLIPS >= max(chip_smoke.FULL_BATCH,
                                         load_config(os.path.join(
                                             ROOT, chip_smoke.TRAIN_LORA_CONFIG_PATH))
                                         ["train_batch_size"])


def test_epsilon_on_a_zero_snr_schedule_breaks_the_motion_loss_at_t_999_on_both_sides():
    """``configs/train_mask_motion.yaml``: ``rescale_schedule: true`` and no
    prediction type, so JAX's ``schedule_from_json`` gives ε on a
    zero-terminal-SNR schedule; x̂0 = (x − sqrt(1 − ᾱ)·ε)/sqrt(ᾱ) divides
    by sqrt(ᾱ_999) = 0, and the motion loss is not finite — in JAX and in
    the port alike (ROADMAP queue 3), at t = 999 only."""
    from animate_anything_tpu.diffusion.schedule import pred_x0 as jax_pred_x0
    from animate_anything_tpu.metrics.motion import latent_motion_score as jax_score
    from animate_anything_tpu.models.factory import schedule_from_json as jax_schedule
    from animate_anything_tpu_torch.diffusion.schedule import pred_x0
    from animate_anything_tpu_torch.metrics.motion import latent_motion_score
    from animate_anything_tpu_torch.models.factory import schedule_from_json

    js, ps = jax_schedule({}, rescale=True), schedule_from_json({}, rescale=True)
    assert js.prediction_type == ps.prediction_type == "epsilon"
    assert float(js.alphas_cumprod[999]) == float(ps.alphas_cumprod[999]) == 0.0
    r = np.random.default_rng(0)
    latents, pred, noisy = (r.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
                            for _ in range(3))
    for steps, finite in ((np.array([999, 10], np.int32), False),
                          (np.array([998, 10], np.int32), True)):
        want = np.mean((np.asarray(jax_score(latents)) - np.asarray(jax_score(
            jax_pred_x0(js, pred, noisy, steps)))) ** 2)
        got = float((latent_motion_score(t(latents)) - latent_motion_score(
            pred_x0(ps, t(pred), t(noisy), t(steps).long()))).square().mean())
        assert bool(np.isfinite(want)) == bool(np.isfinite(got)) == finite
        if finite:
            np.testing.assert_allclose(got, want, rtol=1e-5)


def _jax_step_draws(key, shape, jcfg, jsched):
    from test_torch_port_trainer import _jax_draws

    return _jax_draws(key, shape, jcfg, jsched)


@pytest.mark.slow
def test_main_matches_jax_for_two_lora_steps(gifs, tmp_path):
    """JAX's ``main`` and the port's, 2 UNet-LoRA steps at ``tiny_smoke.yaml``
    from one JAX-saved pipeline: the port handed JAX's adapter init
    (``PRNGKey(seed + 7)``) and each step's noise, t and dropout flag (JAX's
    key split per step), the batches the same by the seeded loaders. The
    adapters after each step within 1e-6 but at most one entry in a
    thousand, every entry within lr/10 (lr 1e-4): AdamW moves an entry whose
    gradient lies within a few eps of 0 by a share of lr on fp32 noise
    (1.6e-6 read at one entry of 256 in a tensor after step 1)."""
    from animate_anything_tpu import cli as jax_cli
    from animate_anything_tpu.diffusion import make_schedule as jax_make_schedule
    from animate_anything_tpu.models.lora import init_lora_params as jax_init
    from animate_anything_tpu.models.lora import load_lora as jax_load
    from animate_anything_tpu.train import TrainConfig as JaxConfig
    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.train import trainer

    pipe = save_jax_pipeline(jax_tiny_models(), tmp_path / "pipeline")
    extra = [f"pretrained_model_path={pipe}", "use_unet_lora=true", "lora_rank=4",
             "checkpointing_steps=1"]
    with pytest.warns(UserWarning, match="tokenizer"):
        jax_run = jax_cli.main(**_cfg(gifs, tmp_path / "jax", *extra))
    inits = []
    orig_init = cli.init_lora_params

    def jax_adapter_init(generator, params, cfg):
        want = jax_init(jax.random.PRNGKey(7), jax_tiny_models()["unet_params"], cfg)
        got = orig_init(generator, params, cfg)
        assert set(got) == set(want)
        inits.append(1)
        return {p: {k: t(np.asarray(v)) for k, v in ab.items()} for p, ab in want.items()}

    rng = jax.random.PRNGKey(0)
    draws = []
    jcfg = JaxConfig(motion_mask=True, motion_strength=True)
    jsched = jax_make_schedule()
    for _ in range(2):
        rng, step_rng = jax.random.split(rng)
        draws.append(step_rng)

    def fed(schedule, config, shape, generator, device):
        return _jax_step_draws(draws.pop(0), shape, jcfg, jsched)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "init_lora_params", jax_adapter_init)
        mp.setattr(trainer, "draw_inputs", fed)
        with pytest.warns(UserWarning, match="tokenizer"):
            port_run = cli.main(device="cpu", **_cfg(gifs, tmp_path / "port", *extra))
    assert inits == [1] and not draws
    want_log, got_log = _log(jax_run), _log(port_run)
    assert [r["step"] for r in got_log] == [r["step"] for r in want_log] == [1, 2]
    for got, want in zip(got_log, want_log):
        for k in ("loss", "mse_loss", "motion_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{k} @ {got['step']}")
    worst, off, total = 0.0, 0, 0
    for step in (1, 2):
        want, _ = jax_load(os.path.join(jax_run, f"lora_step_{step}.safetensors"))
        got, _ = jax_load(os.path.join(port_run, f"lora_step_{step}.safetensors"))
        assert set(got) == set(want)
        for p in want:
            for part in ("down", "up"):
                diff = np.abs(got[p][part] - want[p][part])
                worst = max(worst, float(diff.max()))
                off, total = off + int((diff > 1e-6).sum()), total + diff.size
                assert diff.max() <= 0.1 * LR, f"{p}.{part} @ {step}"
    assert off <= total // 1000, f"{off} of {total} adapter entries off by more than 1e-6"
    rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got_log, want_log)
              for k in ("loss", "mse_loss", "motion_loss", "grad_norm"))
    print(f"main against JAX, 2 LoRA steps: max relative metric error {rel:.3g}, max "
          f"|adapter error| {worst:.3g} ({off} of {total} entries above 1e-6)")
