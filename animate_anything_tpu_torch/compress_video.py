"""Offline dataset prep: video re-encode and caption-JSON builders — the port
of the root ``compress_video.py``. No device work.

    python -m animate_anything_tpu_torch.compress_video compress --input_dir raw/ --output_dir vids512/
    python -m animate_anything_tpu_torch.compress_video frames --input_dir vids512/ --output_dir shards/
    python -m animate_anything_tpu_torch.compress_video webvid --csv results.csv --video_dir vids512/ --out data.json
    python -m animate_anything_tpu_torch.compress_video folder_json --video_dir vids/ --out data.json

``compress`` re-encodes clips to 512 px with ffmpeg, in parallel, and
raises ``SystemExit`` with instructions when no ffmpeg binary exists.
``frames`` turns each clip into a frame-directory shard (numbered PNGs and a
``meta.json`` with the source fps) that ``data/video_io.VideoReader`` reads
with no video backend. ``webvid`` and ``folder_json`` write the
``video_json`` dataset file from a WebVid ``results.csv`` or from a folder
of clips with sibling ``.txt`` captions.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import csv
import json
import os
import shutil
import subprocess


VID_EXTS = (".mp4", ".avi", ".mov", ".webm", ".gif")


def compress(input_dir: str, output_dir: str, size: int = 512, workers: int = 4) -> None:
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise SystemExit(
            "ffmpeg not found — the re-encode step needs an ffmpeg binary. "
            "Run this tool on a box with ffmpeg, or use gif/webp/frame-dir "
            "datasets which need no re-encode."
        )
    os.makedirs(output_dir, exist_ok=True)
    files = [f for f in os.listdir(input_dir) if f.lower().endswith(VID_EXTS)]

    def one(name: str) -> str:
        src = os.path.join(input_dir, name)
        dst = os.path.join(output_dir, os.path.splitext(name)[0] + ".mp4")
        cmd = [ffmpeg, "-y", "-i", src,
               "-vf", f"scale='min({size},iw)':-2", "-c:v", "libx264",
               "-preset", "fast", "-an", dst]
        subprocess.run(cmd, capture_output=True, check=True)
        return dst

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for dst in ex.map(one, files):
            print(dst)


def frames(input_dir: str, output_dir: str, workers: int = 4) -> None:
    """Convert each clip into a frame-dir shard (numbered .png + meta.json
    with the source fps) that ``data/video_io.py`` reads without any video
    backend: the offline step that makes mp4/webm datasets (e.g. WebVid)
    usable where neither ffmpeg nor decord exists.

    Decode order per clip: PIL (gif/webp/apng) in-process, else ffmpeg."""
    from animate_anything_tpu_torch.data.video_io import VideoReader

    os.makedirs(output_dir, exist_ok=True)
    files = [f for f in os.listdir(input_dir) if f.lower().endswith(VID_EXTS + (".webp",))]

    def one(name: str) -> str:
        from PIL import Image

        vr = VideoReader(os.path.join(input_dir, name))
        shard = os.path.join(output_dir, os.path.splitext(name)[0])
        os.makedirs(shard, exist_ok=True)
        batch = vr.get_batch(range(len(vr)))
        for i, fr in enumerate(batch):
            Image.fromarray(fr).save(os.path.join(shard, f"{i:06d}.png"))
        with open(os.path.join(shard, "meta.json"), "w") as f:
            json.dump({"fps": vr.fps, "n_frames": len(vr), "source": name}, f)
        # caption sidecar travels with the shard
        cap = os.path.join(input_dir, os.path.splitext(name)[0] + ".txt")
        if os.path.exists(cap):
            shutil.copy(cap, shard + ".txt")
        return shard

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for shard in ex.map(one, files):
            print(shard)


def webvid(csv_path: str, video_dir: str, out: str) -> None:
    """WebVid results.csv (videoid, name columns) → video_json dataset file."""
    items = []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            vid = row.get("videoid") or row.get("video_id") or ""
            cap = row.get("name") or row.get("caption") or ""
            path = os.path.join(video_dir, f"{vid}.mp4")
            if os.path.exists(path):
                items.append({"video": path, "caption": cap})
    with open(out, "w") as f:
        json.dump(items, f)
    print(f"{len(items)} items → {out}")


def folder_json(video_dir: str, out: str) -> None:
    """Folder of videos (+ sibling .txt captions) → video_json dataset file."""
    items = []
    for name in sorted(os.listdir(video_dir)):
        if not name.lower().endswith(VID_EXTS):
            continue
        path = os.path.join(video_dir, name)
        cap_file = os.path.splitext(path)[0] + ".txt"
        cap = open(cap_file).read().strip() if os.path.exists(cap_file) else ""
        items.append({"video": path, "caption": cap})
    with open(out, "w") as f:
        json.dump(items, f)
    print(f"{len(items)} items → {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compress")
    c.add_argument("--input_dir", required=True)
    c.add_argument("--output_dir", required=True)
    c.add_argument("--size", type=int, default=512)
    c.add_argument("--workers", type=int, default=4)
    fr = sub.add_parser("frames")
    fr.add_argument("--input_dir", required=True)
    fr.add_argument("--output_dir", required=True)
    fr.add_argument("--workers", type=int, default=4)
    w = sub.add_parser("webvid")
    w.add_argument("--csv", required=True)
    w.add_argument("--video_dir", required=True)
    w.add_argument("--out", required=True)
    fj = sub.add_parser("folder_json")
    fj.add_argument("--video_dir", required=True)
    fj.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    if a.cmd == "compress":
        compress(a.input_dir, a.output_dir, a.size, a.workers)
    elif a.cmd == "frames":
        frames(a.input_dir, a.output_dir, a.workers)
    elif a.cmd == "webvid":
        webvid(a.csv, a.video_dir, a.out)
    else:
        folder_json(a.video_dir, a.out)


if __name__ == "__main__":
    main()
