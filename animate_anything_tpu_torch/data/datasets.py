"""The dataset suite — the port of ``animate_anything_tpu/data/datasets.py``:
the five dataset types (``video_blip``, ``video_json``, ``single_video``,
``image``, ``folder``) by their ``__getname__`` keys, the latent cache, the
registry ``get_train_dataset``, ``extend_datasets`` and ``ConcatDataset``.

An item: {pixel_values (f, h, w, 3) fp32 in [-1, 1], prompt_ids (77,) int32,
text_prompt, mask (h, w) uint8 {0, 255}, motion (int), dataset}. A clip whose
motion score is under ``motion_threshold`` is redrawn at a random index
(Python's ``random``), and an unreadable item likewise; all host-side numpy
and PIL, the order of draws JAX's.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Sequence

import numpy as np

from animate_anything_tpu_torch.data.video_io import (
    VideoReader,
    normalize_input,
    read_video_clip,
    resize_center_crop,
)
from animate_anything_tpu_torch.metrics.motion import (calculate_motion_score,
                                                       get_moved_area_mask)
from animate_anything_tpu_torch.utils.media import load_image

VID_EXTS = (".mp4", ".avi", ".mov", ".webm", ".flv", ".gif", ".webp")
IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def tokenize_prompt(prompt: str, tokenizer, max_length: int = 77) -> np.ndarray:
    if tokenizer is None:
        return np.zeros((max_length,), np.int32)
    if callable(tokenizer) and not hasattr(tokenizer, "model_max_length"):
        return np.asarray(tokenizer(prompt), np.int32)
    ids = tokenizer(
        prompt, truncation=True, padding="max_length",
        max_length=getattr(tokenizer, "model_max_length", max_length),
        return_tensors="np",
    ).input_ids[0]
    return np.asarray(ids, np.int32)


class _BaseVideoDataset:
    """Shared item assembly: decode → normalize → motion mask + score."""

    name = "base"

    def __init__(self, tokenizer=None, width=256, height=256, n_sample_frames=8,
                 fps=8, use_bucketing=False, motion_threshold=0, **kw):
        self.tokenizer = tokenizer
        self.width = width
        self.height = height
        self.n_sample_frames = n_sample_frames
        self.fps = fps
        self.use_bucketing = use_bucketing
        self.motion_threshold = motion_threshold

    @classmethod
    def __getname__(cls) -> str:
        return cls.name

    def _example(self, frames_uint8: np.ndarray, prompt: str) -> Dict[str, Any]:
        return {
            "pixel_values": normalize_input(frames_uint8),
            "prompt_ids": tokenize_prompt(prompt, self.tokenizer),
            "text_prompt": prompt,
            "mask": get_moved_area_mask(frames_uint8),
            "motion": calculate_motion_score(frames_uint8)
            if len(frames_uint8) > 1 else 0,
            "dataset": self.__getname__(),
        }

    def _resample_if_static(self, example: Dict[str, Any], depth: int = 0) -> Dict[str, Any]:
        """Reject a low-motion clip and draw another index."""
        if example["motion"] < self.motion_threshold and len(self) > 1 and depth < 16:
            return self._resample_if_static(
                self.getitem_raw(random.randint(0, len(self) - 1)), depth + 1
            )
        return example

    def getitem_raw(self, index: int) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict[str, Any]:
        # a corrupt or unreadable item draws a random other index instead of
        # ending the epoch
        for _ in range(8):
            try:
                return self._resample_if_static(self.getitem_raw(index))
            except Exception as e:
                if len(self) <= 1:
                    raise
                print(f"[data] failed to read item {index} ({e!r}); resampling")
                index = random.randint(0, len(self) - 1)
        raise RuntimeError("too many consecutive unreadable dataset items")


class VideoBlipDataset(_BaseVideoDataset):
    """Video-BLIP2-Preprocessor json: {"data": [{video_path, data: [{frame_index,
    prompt, clip_path?}]}]} flattened to one item per captioned clip."""

    name = "video_blip"

    def __init__(self, json_path: str = "", json_data=None, vid_data_key="video_path",
                 motion_threshold=50, **kw):
        super().__init__(motion_threshold=motion_threshold, **kw)
        self.vid_data_key = vid_data_key
        if json_data is None and json_path:
            with open(json_path) as f:
                json_data = json.load(f)
        self.items: List[Dict] = []
        for data in (json_data or {}).get("data", []):
            for nested in data.get("data", []):
                self.items.append({
                    "path": nested.get("clip_path") or data[self.vid_data_key],
                    "frame_index": nested.get("frame_index", 0),
                    "prompt": nested.get("prompt", ""),
                })

    def __len__(self):
        return len(self.items)

    def getitem_raw(self, index):
        item = self.items[index]
        frames = read_video_clip(
            item["path"], self.n_sample_frames, self.height, self.width,
            self.fps, self.use_bucketing,
        )
        return self._example(frames, item["prompt"])


class VideoJsonDataset(_BaseVideoDataset):
    """Flat json list: [{"video": path, "caption"/"text": str}, ...] or
    {"data": [...]} (WebVid-style json built by compress_video.py)."""

    name = "video_json"

    def __init__(self, json_path: str = "", video_dir: str = "", **kw):
        super().__init__(**kw)
        self.video_dir = video_dir
        with open(json_path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("data", [])
        self.items = data

    def __len__(self):
        return len(self.items)

    def getitem_raw(self, index):
        item = self.items[index]
        path = item.get("video") or item.get("video_path") or item.get("path")
        if self.video_dir:
            path = os.path.join(self.video_dir, path)
        prompt = item.get("caption") or item.get("text") or item.get("prompt") or ""
        frames = read_video_clip(
            path, self.n_sample_frames, self.height, self.width,
            self.fps, self.use_bucketing,
        )
        return self._example(frames, prompt)


class SingleVideoDataset(_BaseVideoDataset):
    """Chunks of one video, optionally with a single caption."""

    name = "single_video"

    def __init__(self, single_video_path: str = "", single_video_prompt: str = "", **kw):
        super().__init__(**kw)
        self.path = single_video_path
        self.prompt = single_video_prompt
        vr = VideoReader(self.path)
        self._num_chunks = max(1, len(vr) // max(self.n_sample_frames, 1))

    def __len__(self):
        return self._num_chunks

    def getitem_raw(self, index):
        vr = VideoReader(self.path)
        start = index * self.n_sample_frames
        idx = np.arange(start, min(start + self.n_sample_frames, len(vr)))
        if len(idx) < self.n_sample_frames:
            idx = np.linspace(0, len(vr) - 1, self.n_sample_frames).astype(int)
        frames = resize_center_crop(vr.get_batch(idx), self.height, self.width)
        return self._example(frames, self.prompt)


class ImageDataset(_BaseVideoDataset):
    """Single images treated as 1-frame videos (with caption .txt files)."""

    name = "image"

    def __init__(self, image_dir: str = "", fallback_prompt: str = "", **kw):
        super().__init__(**kw)
        self.fallback_prompt = fallback_prompt
        self.files = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)
            if f.lower().endswith(IMG_EXTS)
        ) if image_dir and os.path.isdir(image_dir) else []

    def __len__(self):
        return len(self.files)

    def getitem_raw(self, index):
        path = self.files[index]
        img = load_image(path)
        frames = resize_center_crop(img[None], self.height, self.width)
        cap = os.path.splitext(path)[0] + ".txt"
        prompt = open(cap).read().strip() if os.path.exists(cap) else self.fallback_prompt
        ex = self._example(frames, prompt)
        ex["mask"] = np.full((self.height, self.width), 255, np.uint8)
        return ex


class FolderDataset(_BaseVideoDataset):
    """All videos under a folder; caption from sibling .txt or folder name."""

    name = "folder"

    def __init__(self, path: str = "", fallback_prompt: str = "", **kw):
        super().__init__(**kw)
        self.fallback_prompt = fallback_prompt or os.path.basename(path or ".")
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith(VID_EXTS) or os.path.isdir(os.path.join(path, f))
        ) if path and os.path.isdir(path) else []

    def __len__(self):
        return len(self.files)

    def getitem_raw(self, index):
        path = self.files[index]
        frames = read_video_clip(
            path, self.n_sample_frames, self.height, self.width,
            self.fps, self.use_bucketing,
        )
        cap = os.path.splitext(path)[0] + ".txt"
        prompt = open(cap).read().strip() if os.path.exists(cap) else self.fallback_prompt
        return self._example(frames, prompt)


class CachedDataset:
    """The precomputed-latent cache: one .npz a clip, as JAX writes it."""

    name = "cached"

    def __init__(self, cache_dir: str = "", **kw):
        self.files = sorted(
            os.path.join(cache_dir, f) for f in os.listdir(cache_dir)
            if f.endswith(".npz")
        ) if cache_dir and os.path.isdir(cache_dir) else []

    @classmethod
    def __getname__(cls):
        return cls.name

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        with np.load(self.files[index], allow_pickle=True) as z:
            return {k: z[k] for k in z.files}

    @staticmethod
    def save_item(cache_dir: str, index: int, item: Dict[str, Any]) -> str:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"cached_{index:08d}.npz")
        np.savez_compressed(path, **{k: v for k, v in item.items() if not isinstance(v, str)})
        return path


_REGISTRY = {
    cls.name: cls
    for cls in (VideoBlipDataset, VideoJsonDataset, SingleVideoDataset, ImageDataset, FolderDataset)
}


def get_train_dataset(dataset_types: Sequence[str], train_data: Dict, tokenizer=None) -> list:
    """Registry lookup by ``__getname__``."""
    out = []
    for want in dataset_types:
        if want not in _REGISTRY:
            raise ValueError(f"dataset type {want!r} not in {sorted(_REGISTRY)}")
        out.append(_REGISTRY[want](tokenizer=tokenizer, **train_data))
    if not out:
        raise ValueError("dataset types were empty")
    return out


def extend_datasets(datasets: list, keys: Sequence[str] = (), extend: bool = True) -> list:
    """Balance dataset lengths by repeating the shorter ones: everything
    stretched to the longest."""
    if not extend or len(datasets) < 2:
        return datasets
    longest = max(len(d) for d in datasets)

    class _Repeated:
        def __init__(self, ds, n):
            self.ds, self.n = ds, n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return self.ds[i % len(self.ds)]

        def __getattr__(self, a):
            return getattr(self.ds, a)

    return [d if len(d) == longest else _Repeated(d, longest) for d in datasets]


class ConcatDataset:
    def __init__(self, datasets: list):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index):
        di = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[di][index - int(self._offsets[di])]
