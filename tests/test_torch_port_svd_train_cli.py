"""The port's SVD training entry point (``cli_svd.main``, ``train_svd.py``
without ``--eval``) on the CPU, and its pipeline directory against the JAX
package's ``_save_svd_pipeline``.

- One step of ``train_svd`` at ``configs/train_svd_mask.yaml`` with
  ``model_size=tiny`` on two synthetic 3-frame 64×64 clips (``video_blip``
  PNG frame directories): the run directory, a finite loss, the train-state
  checkpoint and the ``pipeline_step_1/unet`` directory, whose weights are
  the trained fp32 masters bit for bit and load into a new UNet strictly.
- ``_save_svd_pipeline`` on the port's UNet and JAX's on the same params
  write the same ``config.json`` and the same safetensors: keys, shapes and
  values, exactly.
"""

import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from test_torch_port_helpers import jax_params, load_into, one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "train_svd_mask.yaml")


def write_clips(root, n: int = 2, frames: int = 3, res: int = 64) -> str:
    """``n`` clips of ``frames`` PNG frames (a random image drifting 4 px a
    frame) and their ``video_blip`` JSON; → the JSON's path."""
    from PIL import Image

    rng = np.random.default_rng(0)
    clips = []
    for i in range(n):
        d = os.path.join(root, f"clip_{i}")
        os.makedirs(d)
        base = (rng.random((res, res, 3)) * 255).astype(np.uint8)
        for k in range(frames):
            Image.fromarray(np.roll(base, 4 * k, axis=1)).save(os.path.join(d, f"{k:04d}.png"))
        clips.append(d)
    path = os.path.join(root, "blip.json")
    with open(path, "w") as f:
        json.dump({"data": [{"video_path": c, "data": [{"frame_index": 0, "prompt": "drift"}]}
                            for c in clips]}, f)
    return path


def test_train_svd_takes_a_step_and_writes_its_pipeline(tmp_path, monkeypatch):
    from animate_anything_tpu_torch import cli_svd, train_svd
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)

    states = []
    monkeypatch.setattr(cli_svd, "create_train_state",
                        lambda *a, _f=cli_svd.create_train_state: states.append(_f(*a))
                        or states[-1])
    json_path = write_clips(tmp_path / "data")
    train_svd.cli(["--config", CONFIG, "--device", "cpu", "model_size=tiny",
                   "train_data.width=64", "train_data.height=64", "train_data.n_sample_frames=3",
                   f"train_data.json_path={json_path}", "train_batch_size=2",
                   "max_train_steps=1", f"output_dir={tmp_path / 'out'}"])
    run, = [tmp_path / "out" / d for d in os.listdir(tmp_path / "out")]
    assert run.name.startswith("svd_")
    with open(run / "train_log.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert len(logged) == 1 and all(np.isfinite(logged[0][k]) for k in
                                    ("loss", "edm_loss", "mask_consistency_loss", "grad_norm"))
    assert logged[0]["grad_norm"] > 0
    assert os.path.isfile(run / "ckpt" / "step_00000001" / "train_state.pt")
    state, = states
    assert state.step == 1 and state.model.config.gradient_checkpointing
    assert state.model.conv_in.weight.dtype == torch.bfloat16        # the policy's cast

    unet_dir = run / "pipeline_step_1" / "unet"
    with open(unet_dir / "config.json") as f:
        cfg = json.load(f)
    assert cfg.pop("_class_name") == "UNetSpatioTemporalConditionModel"
    assert cfg["in_channels"] == 9 and cfg["attn_impl"] == "pallas"
    saved = load_file(str(unet_dir / "diffusion_pytorch_model.safetensors"))
    assert set(saved) == set(state.masters)
    for name, master in state.masters.items():
        assert saved[name].dtype == np.float32
        np.testing.assert_array_equal(saved[name], master.numpy(), err_msg=name)
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    UNetSpatioTemporalConditionModel(SVDUNetConfig(**cfg)).load_state_dict(
        {k: torch.from_numpy(v) for k, v in saved.items()}, strict=True)


def test_save_svd_pipeline_matches_jax(tmp_path):
    from animate_anything_tpu import cli_svd as jax_cli
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet

    from animate_anything_tpu_torch.cli_svd import _save_svd_pipeline
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import svd_unet_state_dict

    kw = dict(in_channels=9, attn_impl="pallas", gradient_checkpointing=True)
    z = np.zeros((1, 2, 8, 8, 9), np.float32)
    params = jax_params(JaxUNet(JaxCfg.tiny(**kw)), z, np.float32(0.5),
                        np.zeros((1, 1, 32), np.float32), np.zeros((1, 3), np.float32))
    jax_cli._save_svd_pipeline(str(tmp_path / "jax"), params, JaxCfg.tiny(**kw))
    port = load_into(UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny(**kw)),
                     svd_unet_state_dict(params))
    assert _save_svd_pipeline(str(tmp_path / "port"), port,
                              SVDUNetConfig.tiny(**kw)) == str(tmp_path / "port")
    for side in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / side)) == ["unet"]
    with open(tmp_path / "jax" / "unet" / "config.json") as a, \
            open(tmp_path / "port" / "unet" / "config.json") as b:
        assert json.load(b) == json.load(a)
    want = load_file(str(tmp_path / "jax" / "unet" / "diffusion_pytorch_model.safetensors"))
    got = load_file(str(tmp_path / "port" / "unet" / "diffusion_pytorch_model.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_svd_refuses_a_mesh_of_several_devices(tmp_path):
    from animate_anything_tpu_torch import cli_svd

    with pytest.raises(ValueError, match="mesh"):
        cli_svd.cli(["--config", CONFIG, "--device", "cpu", "model_size=tiny", "mesh.data=2",
                     f"output_dir={tmp_path}"])
