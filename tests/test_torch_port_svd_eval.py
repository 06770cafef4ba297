"""The port's SVD eval entry point (``cli_svd.py``, JAX's ``train_svd.py
--eval``) on the CPU at ``configs/train_svd_mask.yaml`` with a tiny
override (the tiny models, 64×64 or 128×128, 3 frames, 2 Euler steps):

- ``main_eval`` writes its gif; the YAML's image (``example/barbie2.jpg``)
  is not in the repository, so it animates the seeded random image, with
  the all-ones mask;
- the ``eval_file`` route: each listed image ``iters`` times under a
  directory of its own, the area fit to 64-multiples, the ``_label.jpg``
  sidecar mask binarised and written beside the sample;
- ``build_svd_models`` at both sizes' shapes and the bf16 policy;
- the CLI: ``--eval`` runs, training raises naming the next slice, and
  ``train_svd`` forwards to it.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_helpers import one_thread  # noqa: F401 (autouse fixture)

CONFIG = "configs/train_svd_mask.yaml"
TINY = ["model_size=tiny", "validation_data.num_frames=3",
        "validation_data.num_inference_steps=2", "validation_data.decode_chunk_size=2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(tmp_path, *extra):
    from animate_anything_tpu_torch.core.config import load_config

    over = TINY + [f"output_dir={tmp_path}/out", "validation_data.width=64",
                   "validation_data.height=64", *extra]
    return load_config(os.path.join(REPO, CONFIG), overrides=over).to_dict()


def _gif(path):
    with Image.open(path) as im:
        return im.n_frames, im.size


def test_main_eval_writes_its_gif_from_the_seeded_random_image(tmp_path):
    from animate_anything_tpu_torch.cli_svd import main_eval

    cfg = _cfg(tmp_path)
    assert not os.path.exists(os.path.join(REPO, cfg["validation_data"]["prompt_image"]))
    assert cfg["motion_mask"] and cfg["attn_impl"] == "pallas"
    out = main_eval(device="cpu", **cfg)
    assert out["sample_paths"] == [out["sample_path"]]
    assert out["sample_path"] == os.path.join(str(tmp_path), "out", "svd_sample.gif")
    assert _gif(out["sample_path"]) == (3, (64, 64))
    again = main_eval(device="cpu", **dict(cfg, output_dir=str(tmp_path / "again")))
    a, b = (np.asarray(Image.open(p).convert("RGB")) for p in (out["sample_path"],
                                                              again["sample_path"]))
    np.testing.assert_array_equal(a, b)    # seeded weights, image and noise


def test_main_eval_file_route_fits_the_area_and_reads_the_sidecar_mask(tmp_path):
    from animate_anything_tpu_torch.cli_svd import main_eval

    r = np.random.default_rng(0)
    wide = tmp_path / "wide.png"
    Image.fromarray(r.integers(0, 256, (128, 256, 3), dtype=np.uint8)).save(wide)
    label = np.zeros((128, 256, 3), np.uint8)
    label[:, :128] = 255
    Image.fromarray(label).save(tmp_path / "wide_label.jpg")
    square = tmp_path / "sq.png"
    Image.fromarray(r.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(square)
    listing = tmp_path / "eval.json"
    listing.write_text(json.dumps([[str(wide), "a"], [str(square), "b"]]))
    cfg = _cfg(tmp_path, f"eval_file={listing}", "iters=2", "validation_data.width=128",
               "validation_data.height=128")
    out = main_eval(device="cpu", **cfg)
    sub = os.path.join(str(tmp_path), "out")
    want = [os.path.join(sub, stem, f"{i}.gif") for stem in ("wide", "sq") for i in range(2)]
    assert out["sample_paths"] == want and out["sample_path"] == want[-1]
    # 256×128 scaled to the 128² area, sides snapped to 64: 192×64
    assert _gif(want[0]) == (3, (192, 64)) and _gif(want[2]) == (3, (128, 128))
    mask = np.asarray(Image.open(os.path.join(sub, "wide", "0_mask.jpg")))
    assert mask.shape == (128, 256) and mask[:, :120].min() > 200 and mask[:, 136:].max() < 50
    assert not os.path.exists(os.path.join(sub, "sq", "0_mask.jpg"))


def test_build_svd_models_shapes_and_policy():
    from animate_anything_tpu_torch.cli_svd import build_svd_models

    m = build_svd_models(motion_mask=True, model_size="tiny", compute_dtype=torch.bfloat16,
                         device="cpu", attn_impl="pallas")
    assert m["unet_config"].in_channels == 9 and m["unet_config"].attn_impl == "pallas"
    assert m["image_config"].projection_dim == m["unet_config"].cross_attention_dim
    assert m["unet"].conv_in.weight.dtype == torch.bfloat16
    assert m["unet"].conv_norm_out.weight.dtype == torch.float32
    assert float(m["unet"].mid_block.resnets[0].time_mixer.mix_factor.detach()) == 0.5
    assert not m["unet"].training and not m["image_encoder"].training
    m8 = build_svd_models(model_size="tiny", device="cpu")
    assert m8["unet_config"].in_channels == 8 and m8["unet"].conv_in.weight.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_svd_models(model_size="tiny")


def test_cli_trains_nothing_yet_and_train_svd_forwards(tmp_path, monkeypatch):
    """Without ``--eval`` the CLI trains (``cli_svd.main``; the step itself is
    held in ``test_torch_port_svd_train_cli.py``), with it it samples."""
    from animate_anything_tpu_torch import cli_svd, train_svd

    seen, trained = {}, {}
    monkeypatch.setattr(cli_svd, "main", lambda **kw: trained.update(kw))
    monkeypatch.setattr(cli_svd, "main_eval", lambda **kw: seen.update(kw))
    cli_svd.cli(["--config", os.path.join(REPO, CONFIG), "--device", "cpu"])
    assert trained["device"] == "cpu" and trained["gradient_checkpointing"] is True
    assert trained["train_batch_size"] == 3 and not seen
    train_svd.cli(["--config", os.path.join(REPO, CONFIG), "--eval", "--device", "cpu",
                   "model_size=tiny", f"output_dir={tmp_path}"])
    assert seen["device"] == "cpu" and seen["model_size"] == "tiny"
    assert seen["output_dir"] == str(tmp_path) and seen["motion_mask"] is True
