"""The port's dataset-prep tool (``animate_anything_tpu_torch/compress_video.py``)
against the root ``compress_video.py`` on the same inputs: the caption-JSON
builders write the same files, ``frames`` writes identical PNG shards and
``meta.json`` for a gif and a webp (read back through the port's
``VideoReader`` equal to the clip's frames), and ``compress`` raises
``SystemExit`` when there is no ffmpeg."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from animate_anything_tpu_torch import compress_video as port

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def root():
    spec = importlib.util.spec_from_file_location("root_compress_video",
                                                  REPO / "compress_video.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clip(seed, n=4, size=24):
    r = np.random.default_rng(seed)
    return [(r.random((size, size, 3)) * 255).astype(np.uint8) for _ in range(n)]


def _write_inputs(d: Path, mp4: bool = False):
    d.mkdir()
    gif = [Image.fromarray(f) for f in _clip(0)]
    gif[0].save(d / "a.gif", save_all=True, append_images=gif[1:], duration=200, loop=0)
    webp = [Image.fromarray(f) for f in _clip(1, n=3)]
    webp[0].save(d / "b.webp", save_all=True, append_images=webp[1:], duration=100,
                 lossless=True)
    (d / "a.txt").write_text("a gif clip\n")
    if mp4:                                     # listed by the json tools, never decoded
        (d / "c.mp4").write_bytes(b"")
    (d / "notes.md").write_text("not a clip")


def _tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_frames_writes_identical_shards(root, tmp_path):
    _write_inputs(tmp_path / "in")
    root.frames(str(tmp_path / "in"), str(tmp_path / "want"), workers=2)
    port.frames(str(tmp_path / "in"), str(tmp_path / "got"), workers=2)
    got, want = _tree(tmp_path / "got"), _tree(tmp_path / "want")
    assert got == want
    assert {"a/meta.json", "a/000003.png", "b/000002.png", "a.txt"} <= set(got)
    meta = json.loads(got["a/meta.json"])
    assert meta == {"fps": 5.0, "n_frames": 4, "source": "a.gif"}

    from animate_anything_tpu_torch.data.video_io import VideoReader

    vr = VideoReader(str(tmp_path / "got" / "b"))
    np.testing.assert_array_equal(vr.get_batch(range(len(vr))), np.stack(_clip(1, n=3)))
    assert vr.fps == json.loads(got["b/meta.json"])["fps"]


def test_folder_json_and_webvid_write_the_same_files(root, tmp_path):
    _write_inputs(tmp_path / "in", mp4=True)
    for tool, name in ((root, "want"), (port, "got")):
        tool.folder_json(str(tmp_path / "in"), str(tmp_path / f"{name}_folder.json"))
    csv = tmp_path / "results.csv"
    csv.write_text("videoid,name\nc,a clip\nmissing,gone\n")
    for tool, name in ((root, "want"), (port, "got")):
        tool.webvid(str(csv), str(tmp_path / "in"), str(tmp_path / f"{name}_webvid.json"))
    for kind in ("folder", "webvid"):
        got = (tmp_path / f"got_{kind}.json").read_bytes()
        assert got == (tmp_path / f"want_{kind}.json").read_bytes()
    items = json.loads((tmp_path / "got_folder.json").read_text())
    assert [os.path.basename(i["video"]) for i in items] == ["a.gif", "c.mp4"]
    assert items[0]["caption"] == "a gif clip"
    assert json.loads((tmp_path / "got_webvid.json").read_text()) == [
        {"video": str(tmp_path / "in" / "c.mp4"), "caption": "a clip"}]


def test_compress_without_ffmpeg_raises_system_exit(root, tmp_path, monkeypatch):
    for mod in (root, port):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
        with pytest.raises(SystemExit, match="ffmpeg not found"):
            mod.compress(str(tmp_path), str(tmp_path / "out"))


def test_main_runs_the_subcommands(tmp_path, capsys):
    _write_inputs(tmp_path / "in")
    port.main(["folder_json", "--video_dir", str(tmp_path / "in"),
               "--out", str(tmp_path / "d.json")])
    assert "1 items" in capsys.readouterr().out
    port.main(["frames", "--input_dir", str(tmp_path / "in"),
               "--output_dir", str(tmp_path / "shards"), "--workers", "1"])
    assert (tmp_path / "shards" / "a" / "000000.png").exists()
