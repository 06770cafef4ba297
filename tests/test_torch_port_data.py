"""The port's data pipeline (``data/``, ``metrics/motion.py``'s motion score)
against the JAX package's, on the CPU, on the same synthetic files (gifs, a
frame directory with a ``meta.json`` fps, images with caption files), each
side with its own hash tokenizer:

- every dataset class (``folder``, ``video_json``, ``video_blip``,
  ``single_video``, ``image``), the registry, ``extend_datasets`` and
  ``ConcatDataset``: every item equal to JAX's (pixels bit for bit, ids,
  masks, motion scores, prompts), the motion-threshold redraws included
  (Python's ``random`` seeded alike);
- ``collate`` and the ``DataLoader``'s batches and order over two epochs;
- the latent cache JAX writes read by the port;
- ``calculate_motion_score`` on its native and numpy paths;
- ``device_prefetch`` on the CPU: tensors equal to the arrays, strings kept,
  a mesh of more than one device refused, the card asked for without one
  refused;
- the pure ffmpeg helpers equal to JAX's.
"""

import json
import random

import numpy as np
import pytest
import torch
from PIL import Image


def _frames(f=8, h=48, w=64, moving=True, seed=0):
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    out = []
    for i in range(f):
        fr = base.copy()
        if moving:
            fr[10:20, (5 + 4 * i):(15 + 4 * i)] = [255, 0, 0]
        out.append(fr)
    return out


def _gif(path, **kw):
    frames = [Image.fromarray(f) for f in _frames(**kw)]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=100, loop=0)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    vids = d / "vids"
    vids.mkdir()
    _gif(vids / "a.gif")
    _gif(vids / "b.gif", seed=1)
    _gif(vids / "still.gif", moving=False, seed=2)
    (vids / "a.txt").write_text("a red square moves")
    shard = vids / "shard"
    shard.mkdir()
    for i, fr in enumerate(_frames(f=12, seed=3)):
        Image.fromarray(fr).save(shard / f"{i:04d}.png")
    (shard / "meta.json").write_text(json.dumps({"fps": 16}))
    imgs = d / "imgs"
    imgs.mkdir()
    for i in range(2):
        Image.fromarray(_frames(f=1, seed=4 + i)[0]).save(imgs / f"x{i}.png")
    (imgs / "x0.txt").write_text("an image")
    (d / "clips.json").write_text(json.dumps(
        [{"video": "a.gif", "caption": "hello"}, {"video": "shard", "text": "frames"},
         {"video": "still.gif", "caption": "still"}]))
    (d / "blip.json").write_text(json.dumps({"data": [
        {"video_path": str(vids / "a.gif"),
         "data": [{"frame_index": 0, "prompt": "p1"}, {"frame_index": 2, "prompt": "p2"}]},
        {"video_path": str(vids / "b.gif"), "data": [{"prompt": "p3", "clip_path":
                                                       str(vids / "still.gif")}]}]}))
    return d


def _tokenizers():
    from animate_anything_tpu.models.factory import HashTokenizer as JaxTok
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    return JaxTok(), HashTokenizer()


def _specs(d):
    vids = str(d / "vids")
    kw = dict(width=32, height=24, n_sample_frames=4)
    return {
        "folder": dict(path=vids, fallback_prompt="fb", motion_threshold=0, **kw),
        "folder-threshold": dict(path=vids, motion_threshold=40, **kw),
        "video_json": dict(json_path=str(d / "clips.json"), video_dir=vids, **kw),
        "video_blip": dict(json_path=str(d / "blip.json"), motion_threshold=0, **kw),
        "video_blip-threshold": dict(json_path=str(d / "blip.json"), **kw),
        "single_video": dict(single_video_path=str(d / "vids" / "shard"),
                             single_video_prompt="sv", **kw),
        "image": dict(image_dir=str(d / "imgs"), fallback_prompt="img", width=32, height=24),
        "folder-bucketing": dict(path=vids, use_bucketing=True, motion_threshold=0,
                                 width=256, height=256, n_sample_frames=4, fps=16),
    }


def _assert_items_equal(got, want, where=""):
    assert set(got) == set(want), where
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, f"{where} {k}"
            np.testing.assert_array_equal(got[k], v, err_msg=f"{where} {k}")
        else:
            assert got[k] == v, f"{where} {k}"


@pytest.mark.parametrize("spec", ["folder", "folder-threshold", "video_json", "video_blip",
                                  "video_blip-threshold", "single_video", "image",
                                  "folder-bucketing"])
def test_dataset_items_match_jax(files, spec):
    from animate_anything_tpu.data import get_train_dataset as jax_get
    from animate_anything_tpu_torch.data import get_train_dataset

    kind = spec.split("-")[0]
    jtok, ptok = _tokenizers()
    want_ds, = jax_get([kind], _specs(files)[spec], jtok)
    got_ds, = get_train_dataset([kind], _specs(files)[spec], ptok)
    assert type(got_ds).__name__ == type(want_ds).__name__
    assert got_ds.__getname__() == want_ds.__getname__() == kind
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        random.seed(i)
        want = want_ds[i]
        random.seed(i)
        _assert_items_equal(got_ds[i], want, f"{spec}[{i}]")


def test_registry_refuses_an_unknown_type_and_extend_balances(files):
    from animate_anything_tpu.data import extend_datasets as jax_extend
    from animate_anything_tpu_torch.data import (ConcatDataset, extend_datasets,
                                                 get_train_dataset)

    with pytest.raises(ValueError, match="not in"):
        get_train_dataset(["nope"], {})
    with pytest.raises(ValueError, match="empty"):
        get_train_dataset([], {})
    short, long = [{"x": 1}] * 2, [{"x": 2}] * 5
    got, want = extend_datasets([short, long]), jax_extend([short, long])
    assert [len(d) for d in got] == [len(d) for d in want] == [5, 5]
    assert [got[0][i] for i in range(5)] == [want[0][i] for i in range(5)]
    cat = ConcatDataset([short, long])
    assert len(cat) == 7 and cat[1] == {"x": 1} and cat[2] == {"x": 2}


def test_collate_and_loader_order_match_jax(files):
    from animate_anything_tpu.data import DataLoader as JaxLoader
    from animate_anything_tpu.data import get_train_dataset as jax_get
    from animate_anything_tpu.data.loader import collate as jax_collate
    from animate_anything_tpu_torch.data import DataLoader, collate, get_train_dataset

    items = [{"a": np.ones(2), "s": "x"}, {"a": np.zeros(2), "s": "y"}]
    got, want = collate(items), jax_collate(items)
    assert got["s"] == want["s"] == ["x", "y"]
    np.testing.assert_array_equal(got["a"], want["a"])

    jtok, ptok = _tokenizers()
    spec = _specs(files)["folder"]
    jax_loader = JaxLoader(jax_get(["folder"], spec, jtok)[0], batch_size=2, seed=3)
    loader = DataLoader(get_train_dataset(["folder"], spec, ptok)[0], batch_size=2, seed=3)
    assert len(loader) == len(jax_loader) == 2
    for epoch in range(2):
        for got, want in zip(loader, jax_loader, strict=True):
            _assert_items_equal(got, want, f"epoch {epoch}")
    with pytest.raises(ValueError, match="no batches"):
        DataLoader([], batch_size=1)


def test_cached_latents_jax_wrote_read_by_the_port(tmp_path):
    from animate_anything_tpu.data import CachedDataset as JaxCached
    from animate_anything_tpu_torch.data import CachedDataset

    r = np.random.default_rng(0)
    items = [{"latents": r.standard_normal((4, 2, 2, 4)).astype(np.float32),
              "mask": r.integers(0, 256, (16, 16)).astype(np.uint8),
              "prompt_ids": np.arange(77, dtype=np.int32)} for _ in range(2)]
    for i, item in enumerate(items):
        JaxCached.save_item(str(tmp_path), i, item)
    ds = CachedDataset(cache_dir=str(tmp_path))
    assert len(ds) == 2 and ds.__getname__() == "cached"
    for i, item in enumerate(items):
        _assert_items_equal(ds[i], item, str(i))


@pytest.mark.parametrize("moving", [True, False])
def test_motion_score_matches_jax_on_both_paths(moving):
    from animate_anything_tpu.metrics import motion as jax_motion
    from animate_anything_tpu_torch.data import native
    from animate_anything_tpu_torch.metrics import motion

    frames = np.stack(_frames(f=6, moving=moving, seed=7))
    assert native.available()
    numpy_score = jax_motion.calculate_motion_score(frames, use_native=False)
    assert motion.calculate_motion_score(frames, use_native=False) == numpy_score
    assert motion.calculate_motion_score(frames) == jax_motion.calculate_motion_score(frames)
    assert motion.calculate_motion_score(frames) == numpy_score
    assert (numpy_score > 0) == moving
    assert motion.calculate_motion_score(frames[:1]) == 0


def test_native_resize_matches_jax_helper():
    from animate_anything_tpu.data import native as jax_native
    from animate_anything_tpu_torch.data import native

    frame = _frames(f=1, seed=8)[0]
    got = native.resize_bilinear(frame, 20, 30)
    want = jax_native.resize_bilinear(frame, 20, 30)
    assert got.shape == (20, 30, 3)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_device_prefetch_on_the_cpu():
    from animate_anything_tpu_torch.data import device_prefetch

    batches = [{"x": np.full((2, 3), i, np.float32), "ids": np.arange(4, dtype=np.int32) + i,
                "text_prompt": [f"p{i}", "q"]} for i in range(3)]
    out = list(device_prefetch(iter(batches), device="cpu", mesh={"data": -1}))
    assert len(out) == 3
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        assert b["ids"].dtype == torch.int32
        assert b["text_prompt"] == [f"p{i}", "q"]
    with pytest.raises(ValueError, match="queue F"):
        next(device_prefetch(iter(batches), device="cpu", mesh={"data": 2}))
    with pytest.raises(ValueError, match="queue F"):
        next(device_prefetch(iter(batches), device="cpu", mesh={"data": 1, "tensor": 2}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(device_prefetch(iter(batches)))


def test_video_reader_reads_a_frame_directory_with_its_fps(files):
    from animate_anything_tpu.data.video_io import VideoReader as JaxReader
    from animate_anything_tpu_torch.data.video_io import VideoReader, read_video_clip

    path = str(files / "vids" / "shard")
    got, want = VideoReader(path), JaxReader(path)
    assert len(got) == len(want) == 12 and got.fps == want.fps == 16.0
    np.testing.assert_array_equal(got.get_batch([0, 5, 11]), want.get_batch([0, 5, 11]))
    clip = read_video_clip(path, 4, 24, 32, sample_fps=8)
    assert clip.shape == (4, 24, 32, 3) and clip.dtype == np.uint8


def test_pure_ffmpeg_helpers_match_jax():
    from animate_anything_tpu.data import video_io as jax_io
    from animate_anything_tpu_torch.data import video_io

    probe = json.dumps({"streams": [{"width": 640, "height": 360, "r_frame_rate": "30000/1001",
                                     "duration": "2.0",
                                     "side_data_list": [{"rotation": -90}]}]})
    assert video_io.parse_probe_json(probe) == jax_io.parse_probe_json(probe)
    assert video_io.display_dims(640, 360, -90) == jax_io.display_dims(640, 360, -90)
    assert video_io.decode_cmd("x.mp4", 3, 5) == jax_io.decode_cmd("x.mp4", 3, 5)
    raw = bytes(range(256)) * 10
    np.testing.assert_array_equal(video_io.frames_from_raw(raw, 4, 3),
                                  jax_io.frames_from_raw(raw, 4, 3))
    np.testing.assert_array_equal(video_io.sample_frame_indices(40, 8, 30.0, 8.0),
                                  jax_io.sample_frame_indices(40, 8, 30.0, 8.0))
