"""Host-side media IO: images, gifs, mp4s, masks — a copy of the parts of
``animate_anything_tpu/utils/media.py`` that the entry points and the data
pipeline use. imageio is optional, as in JAX: without it the mp4 becomes a
gif, and a video that PIL cannot read cannot be read.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
from PIL import Image, ImageDraw


def load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """→ (h, w, 3) uint8 RGB. RGBA is alpha-composited onto white."""
    img = Image.open(path)
    if img.mode == "RGBA":
        bg = Image.new("RGBA", img.size, (255, 255, 255, 255))
        img = Image.alpha_composite(bg, img)
    img = img.convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.LANCZOS)
    return np.asarray(img)


def save_image(path: str, arr: np.ndarray) -> str:
    Image.fromarray(np.asarray(arr)).save(path)
    return path


def fit_image_to_area(path: str, target_h: int, target_w: int,
                      multiple: int = 8) -> np.ndarray:
    """Load an image rescaled so its native aspect fits the target area, each
    side snapped to ``multiple``."""
    with Image.open(path) as im:
        nw, nh = im.size
    scale = float(np.sqrt(nw * nh / (target_h * target_w)))
    th = max(multiple, round(nh / scale / multiple) * multiple)
    tw = max(multiple, round(nw / scale / multiple) * multiple)
    return load_image(path, size=(th, tw))


def load_image_rgba(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """→ (h, w, 4) uint8 RGBA, Lanczos-resized to ``size`` (h, w) if given."""
    img = Image.open(path).convert("RGBA")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.LANCZOS)
    return np.asarray(img)


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float video → uint8."""
    return np.clip((np.asarray(video, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_gif(path: str, frames: np.ndarray | Sequence[np.ndarray], fps: int = 8) -> str:
    frames = [Image.fromarray(np.asarray(f)) for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return path


def save_video(path: str, frames: np.ndarray, fps: int = 8) -> str:
    """mp4 if an imageio ffmpeg backend exists, else .gif."""
    if path.endswith(".mp4"):
        try:
            import imageio.v3 as iio

            iio.imwrite(path, np.asarray(frames), fps=fps, extension=".mp4")
            return path
        except Exception:
            path = path[:-4] + ".gif"
            if os.path.exists(path):
                # the caller already wrote the gif (mp4 was a sidecar)
                return path
    return save_gif(path, frames, fps=fps)


def _pil_frames(path: str) -> np.ndarray:
    from PIL import ImageSequence

    with Image.open(path) as im:
        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])


def load_video_frames(path: str, max_frames: int | None = None) -> np.ndarray:
    """Read frames from gif/webp/mp4 (backend permitting) → (f, h, w, 3).
    Without imageio, PIL reads the formats it knows (gif, webp)."""
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    try:
        frames = iio.imread(path, index=None) if iio is not None else _pil_frames(path)
    except Exception as e:
        raise RuntimeError(
            f"no decoder available for {path}: imageio or its ffmpeg backend is missing; "
            "use gif/webp/frame-directory datasets or precomputed latents") from e
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    if frames.shape[-1] == 4:
        frames = frames[..., :3]
    if max_frames is not None:
        frames = frames[:max_frames]
    return frames


def read_labelme_mask(path: str, shape: tuple[int, int] | None = None) -> np.ndarray:
    """labelme JSON → (h, w) uint8 {0, 255} polygon mask."""
    with open(path) as f:
        data = json.load(f)
    h = data.get("imageHeight") or (shape and shape[0])
    w = data.get("imageWidth") or (shape and shape[1])
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for sh in data.get("shapes", []):
        pts = [tuple(p) for p in sh["points"]]
        if sh.get("shape_type", "polygon") == "rectangle":
            draw.rectangle([pts[0], pts[1]], fill=255)
        else:
            draw.polygon(pts, fill=255)
    mask = np.asarray(img)
    if shape is not None and mask.shape != tuple(shape):
        mask = np.asarray(Image.fromarray(mask).resize((shape[1], shape[0]), Image.NEAREST))
    return mask
