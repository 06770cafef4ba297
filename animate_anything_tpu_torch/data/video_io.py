"""Host-side video reading and frame sampling — a copy of
``animate_anything_tpu/data/video_io.py``.

``VideoReader`` reads, tried in order:
- directories of numbered frames (PNG/JPEG/WebP, read through PIL, with an
  optional ``meta.json`` fps sidecar: the shard format
  ``compress_video.py frames`` writes);
- gif/webp/apng through PIL;
- mp4/webm through an ffmpeg rawvideo pipe where ffmpeg is installed,
  decoding only the window a batch asks for;
- imageio as the last resort.

Frame sampling: stride = round(native fps / sample fps); with too few
frames, a linspace over the whole clip; the LAST ``max_frames`` window.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np
from PIL import Image


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def parse_probe_json(out: str) -> tuple[int, int, float, int, int]:
    """ffprobe -of json output → (width, height, fps, n_frames, rotation_deg).

    Pure (tested without an ffmpeg binary):
    - r_frame_rate \"num/den\" → float fps (missing → 8/1);
    - nb_frames fallback: some containers omit it → duration·fps;
    - rotation from the display-matrix side-data (phone footage)."""
    st = json.loads(out)["streams"][0]
    num, den = (st.get("r_frame_rate") or "8/1").split("/")
    fps = float(num) / max(float(den), 1.0)
    n = int(st.get("nb_frames") or 0)
    if n <= 0 and st.get("duration"):  # some containers omit nb_frames
        n = int(round(float(st["duration"]) * fps))
    rot = 0
    for sd in st.get("side_data_list") or []:
        if "rotation" in sd:
            rot = int(round(float(sd["rotation"])))
    return int(st["width"]), int(st["height"]), fps, n, rot


def display_dims(width: int, height: int, rotation_deg: int) -> tuple[int, int]:
    """Stored stream dims → decoded (display) dims: ffmpeg auto-applies the
    rotation tag during decode, so ±90° tags swap width/height."""
    if rotation_deg % 180 != 0:
        return height, width
    return width, height


def decode_cmd(path: str, start: int = 0, max_frames: int | None = None) -> list[str]:
    """The ffmpeg rawvideo-pipe command for frames [start, start+max_frames).
    Pure (command construction unit-tested without the binary)."""
    cmd = ["ffmpeg", "-v", "error", "-i", path]
    if start or max_frames:
        end = int(start) + int(max_frames) if max_frames else 2**31 - 1
        cmd += ["-vf", f"trim=start_frame={int(start)}:end_frame={end},"
                       "setpts=PTS-STARTPTS"]
    return cmd + ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]


def frames_from_raw(raw: bytes, width: int, height: int) -> np.ndarray:
    """rawvideo rgb24 bytes → (f, h, w, 3) uint8, truncating any partial
    trailing frame (a killed or truncated pipe must not crash the loader)."""
    n = len(raw) // (width * height * 3)
    return np.frombuffer(
        raw[: n * width * height * 3], np.uint8).reshape(n, height, width, 3)


def ffmpeg_probe(path: str) -> tuple[int, int, float, int, int]:
    """→ (width, height, fps, n_frames, rotation_deg) via ffprobe.

    ``width``/``height`` are the stream's STORED dims; ``rotation_deg`` is the
    display-rotation side-data (phone footage). ffmpeg auto-applies that
    rotation during decode, so the decoded frame dims are swapped when
    |rotation| % 180 == 90 — ``ffmpeg_read_video`` accounts for this."""
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height,r_frame_rate,nb_frames,duration"
         ":stream_side_data=rotation", "-of", "json", path],
        capture_output=True, text=True, check=True,
    ).stdout
    return parse_probe_json(out)


def ffmpeg_read_video(
    path: str, max_frames: int | None = None, start: int = 0
) -> tuple[np.ndarray, float]:
    """Decode frames [start, start+max_frames) to (f, h, w, 3) uint8 via an
    ffmpeg rawvideo pipe (the logic in the pure helpers above; only the two
    ``subprocess.run`` calls need the binary).

    Rotation-tagged clips (phone footage) are auto-rotated by ffmpeg, so the
    raw stream's frame dims are the display dims — swapped vs the probe's
    stored dims when the tag is ±90°. Windowed decode keeps host RAM bounded
    by the requested window, not the clip length."""
    w, h, fps, _, rot = ffmpeg_probe(path)
    w, h = display_dims(w, h, rot)
    raw = subprocess.run(
        decode_cmd(path, start, max_frames), capture_output=True, check=True
    ).stdout
    return frames_from_raw(raw, w, h), fps


class VideoReader:
    """Uniform access to frames of a clip: len(), fps, get_batch(indices).

    ``_probe``/``_decode`` inject the ffprobe/ffmpeg callables for the
    real-video windowed path (tests drive the window cache with fakes)."""

    def __init__(self, path: str, _probe=None, _decode=None):
        self.path = path
        self._frames: np.ndarray | None = None
        self._fps = 8.0
        self._decode_fn = _decode or ffmpeg_read_video
        ext = os.path.splitext(path)[1].lower()
        if os.path.isdir(path):
            self._files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
            )
            if not self._files:
                raise FileNotFoundError(f"no frames in {path}")
            self._n = len(self._files)
            # frame-dir shards written by `compress_video.py frames` carry
            # the source clip's fps in a meta.json sidecar
            meta = os.path.join(path, "meta.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    self._fps = float(json.load(f).get("fps", self._fps))
        elif ext in (".gif", ".webp", ".apng", ".png"):
            img = Image.open(path)
            self._n = getattr(img, "n_frames", 1)
            dur = img.info.get("duration") or 125
            self._fps = 1000.0 / max(float(dur), 1.0)
            self._pil = img
            self._files = None
        elif _probe is not None or have_ffmpeg():
            # real-video path (mp4/webm/…): lazy windowed ffmpeg rawvideo
            # pipe — nothing is decoded until get_batch asks for a window,
            # so a minute of 1080p no longer lands in host RAM up front
            _, _, self._fps, self._n, _ = (_probe or ffmpeg_probe)(path)
            self._files = None
            self._win_start = 0
        else:
            from animate_anything_tpu_torch.utils.media import load_video_frames

            self._frames = load_video_frames(path)
            self._n = len(self._frames)
            self._files = None

    def __len__(self) -> int:
        return self._n

    @property
    def fps(self) -> float:
        return self._fps

    def get_batch(self, indices) -> np.ndarray:
        if hasattr(self, "_win_start"):
            # lazy ffmpeg path: decode only the [min, max] frame window,
            # cached across calls while it still covers the request
            idx = np.asarray(indices)
            lo, hi = int(idx.min()), int(idx.max())
            covered = (
                self._frames is not None
                and lo >= self._win_start
                and hi < self._win_start + len(self._frames)
            )
            if not covered:
                self._frames, _ = self._decode_fn(
                    self.path, max_frames=hi - lo + 1, start=lo)
                self._win_start = lo
            return self._frames[idx - self._win_start]
        if self._frames is not None:
            return self._frames[np.asarray(indices)]
        if self._files is not None:
            out = []
            for i in indices:
                out.append(np.asarray(Image.open(self._files[int(i)]).convert("RGB")))
            return np.stack(out)
        out = []
        for i in indices:
            self._pil.seek(int(i))
            out.append(np.asarray(self._pil.convert("RGB")))
        return np.stack(out)


def sample_frame_indices(n_total: int, max_frames: int, native_fps: float,
                         sample_fps: float) -> np.ndarray:
    step = max(1, round(native_fps / max(sample_fps, 1e-6)))
    rng = np.arange(0, n_total, step)
    if len(rng) < max_frames:
        rng = np.linspace(0, n_total - 1, max_frames).astype(int)
    start = max(0, len(rng) - max_frames)
    return np.asarray(rng[start : start + max_frames])


def resize_center_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize (the shorter side to fit) + center crop, through PIL, uint8 in
    and out."""
    out = []
    for fr in frames:
        img = Image.fromarray(fr)
        w0, h0 = img.size
        scale = max(height / h0, width / w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        img = img.resize((nw, nh), Image.BILINEAR)
        top, left = (nh - height) // 2, (nw - width) // 2
        img = img.crop((left, top, left + width, top + height))
        out.append(np.asarray(img))
    return np.stack(out)


def read_video_clip(
    path: str,
    num_frames: int,
    height: int,
    width: int,
    sample_fps: float = 8.0,
    use_bucketing: bool = False,
) -> np.ndarray:
    """→ (f, h, w, 3) uint8, fps-resampled, resized+center-cropped."""
    vr = VideoReader(path)
    idx = sample_frame_indices(len(vr), num_frames, vr.fps, sample_fps)
    frames = vr.get_batch(idx)
    if use_bucketing:
        from animate_anything_tpu_torch.data.bucketing import sensible_buckets

        width, height = sensible_buckets(width, height, frames.shape[2], frames.shape[1])
    return resize_center_crop(frames, height, width)


def normalize_input(frames: np.ndarray) -> np.ndarray:
    """uint8 → float32 in [-1, 1]."""
    return frames.astype(np.float32) / 127.5 - 1.0
