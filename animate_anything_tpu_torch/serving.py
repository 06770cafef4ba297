"""Serving: an async job queue and an HTTP API over the animation
controllers — the port of ``animate_anything_tpu/serving.py``.

One worker thread owns the models and answers the jobs in FIFO order; a
stdlib ``ThreadingHTTPServer`` exposes the API (no dependencies beyond the
standard library). The worker thread sets the device, enters
``torch.inference_mode()`` itself (the mode is thread-local) and launches on
that thread's current stream; each request seeds its own generator. A job
that raises ends ``status: "error"`` with the exception's text.

API:
  POST /generate       {"image_b64"|"image_path", "prompt", "mask_b64"|
                        "mask_path"?, "motion_scale"?, "sample_steps"?,
                        "cfg_scale"?, "seed"?, "workload"?} → {"job_id": ...}
  GET  /jobs/<id>      job status: queued|running|done|error (+timings)
  GET  /result/<id>    the rendered gif bytes
  GET  /healthz        {"ok": true, "queue_depth": n, "jobs_done": n}

Run: ``python -m animate_anything_tpu_torch.serving --config configs/train_mask_motion.yaml
--port 8000`` (``--svd-config configs/train_svd_mask.yaml`` also serves the
SVD family as ``"workload": "svd"``; ``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from animate_anything_tpu_torch.utils import tracing


@dataclass
class Job:
    id: str
    request: Dict[str, Any]
    status: str = "queued"            # queued | running | done | error
    result_path: Optional[str] = None
    error: Optional[str] = None
    created: float = field(default_factory=time.time)
    started: Optional[float] = None
    finished: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"job_id": self.id, "status": self.status}
        if self.result_path:
            d["result_path"] = self.result_path
        if self.error:
            d["error"] = self.error
        if self.started:
            d["queue_seconds"] = round(self.started - self.created, 3)
        if self.finished and self.started:
            d["generate_seconds"] = round(self.finished - self.started, 3)
        return d


def _decode_image(req: Dict[str, Any], key: str) -> Optional[np.ndarray]:
    from PIL import Image

    if req.get(f"{key}_b64"):
        data = base64.b64decode(req[f"{key}_b64"])
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    if req.get(f"{key}_path"):
        return np.asarray(Image.open(req[f"{key}_path"]).convert("RGBA"))
    return None


class VideoServer:
    """Owns the worker thread + job registry; `handler()` builds the HTTP
    request handler class bound to this instance.

    generate_fn(request_dict) -> result file path (``controller_generate_fn``:
    the ``app.AnimateController``'s ``animate``, mask from alpha, strength ×
    mask mean, /8 snap). ``device``: the device the worker thread sets."""

    MAX_FINISHED = 512   # finished-job metadata retained before eviction

    def __init__(self, generate_fn: Callable[[Dict[str, Any]], str], device=None):
        self.generate_fn = generate_fn
        self.device = None if device is None else torch.device(device)
        self.jobs: Dict[str, Job] = {}
        self.q: "queue.Queue[str]" = queue.Queue()
        self.done_count = 0
        self._finished: list[str] = []   # completion order, for eviction
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---- worker ---------------------------------------------------------
    def _run(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            index = self.device.index
            torch.cuda.set_device(torch.cuda.current_device() if index is None else index)
        with torch.inference_mode():
            self._serve_jobs()

    def _serve_jobs(self) -> None:
        while True:
            job_id = self.q.get()
            if job_id is None:  # shutdown sentinel
                return
            job = self.jobs[job_id]
            job.status, job.started = "running", time.time()
            try:
                with tracing.serving(int(job.id, 16)):   # the job's id on its request span
                    job.result_path = self.generate_fn(job.request)
                job.status = "done"
                with self._lock:
                    self.done_count += 1
            except Exception as e:  # surface the error to the client
                job.status, job.error = "error", f"{type(e).__name__}: {e}"
            job.finished = time.time()
            # bound memory: requests can carry multi-MB image payloads, and a
            # production server runs indefinitely — drop the payload now and
            # evict the oldest finished jobs' metadata beyond MAX_FINISHED
            job.request = {}
            with self._lock:
                self._finished.append(job.id)
                while len(self._finished) > self.MAX_FINISHED:
                    self.jobs.pop(self._finished.pop(0), None)

    def submit(self, request: Dict[str, Any]) -> Job:
        job = Job(id=uuid.uuid4().hex[:12], request=request)
        self.jobs[job.id] = job
        self.q.put(job.id)
        return job

    def shutdown(self) -> None:
        self.q.put(None)

    # ---- http -----------------------------------------------------------
    def handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: Dict[str, Any]) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True, "queue_depth": server.q.qsize(),
                                     "jobs_done": server.done_count})
                    return
                if self.path.startswith("/jobs/"):
                    job = server.jobs.get(self.path[len("/jobs/"):])
                    if job is None:
                        self._json(404, {"error": "unknown job"})
                    else:
                        self._json(200, job.to_dict())
                    return
                if self.path.startswith("/result/"):
                    job = server.jobs.get(self.path[len("/result/"):])
                    if job is None or job.status != "done" or not job.result_path:
                        self._json(404, {"error": "no result"})
                        return
                    with open(job.result_path, "rb") as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/gif")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/generate":
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                job = server.submit(req)
                self._json(202, job.to_dict())

        return Handler

    def serve(self, port: int, host: str = "127.0.0.1") -> ThreadingHTTPServer:
        httpd = ThreadingHTTPServer((host, port), self.handler())
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd


def controller_generate_fn(controller) -> Callable[[Dict[str, Any]], str]:
    """Route requests through ``app.AnimateController.animate`` (the mask from
    the alpha layer, the strength scaled by the mask's mean)."""

    def generate(req: Dict[str, Any]) -> str:
        image = _decode_image(req, "image")
        if image is None:
            raise ValueError("request needs image_b64 or image_path")
        mask = _decode_image(req, "mask")
        layer = np.zeros_like(image)
        if mask is not None:
            # the controller reads the drawing layer's ALPHA channel; client
            # masks are grayscale/RGB images whose LUMINANCE is the mask —
            # move it into the alpha slot, binarized
            m = mask[..., 0]
            if m.shape != image.shape[:2]:
                from PIL import Image

                m = np.asarray(Image.fromarray(m).resize(
                    (image.shape[1], image.shape[0]), Image.NEAREST))
            layer[..., 3] = np.where(m != 0, 255, 0)
        init = {"background": image, "layers": [layer]}
        return controller.animate(
            init,
            motion_scale=float(req.get("motion_scale", 3.0)),
            prompt=str(req.get("prompt", "")),
            sample_steps=int(req.get("sample_steps", 25)),
            cfg_scale=float(req.get("cfg_scale", 9.0)),
            seed=int(req.get("seed", -1)),
        )

    return generate


def svd_controller_generate_fn(controller) -> Callable[[Dict[str, Any]], str]:
    """Route requests through ``app_svd.AnimateController`` (SVD i2v / v2v;
    the mask routed by ``in_channels == 9``, a per-frame linspace CFG)."""

    def generate(req: Dict[str, Any]) -> str:
        image = _decode_image(req, "image")
        if image is None:
            raise ValueError("request needs image_b64 or image_path")
        mask = _decode_image(req, "mask")
        return controller.animate(
            image[..., :3],
            mask_img=mask[..., 0] if mask is not None else None,
            steps=int(req.get("sample_steps", 25)),
            min_cfg=float(req.get("min_cfg", 1.0)),
            max_cfg=float(req.get("max_cfg", req.get("cfg_scale", 3.0))),
            seed=int(req.get("seed", 0)),
        )

    return generate


def multi_workload_generate_fn(
    routes: Dict[str, Callable[[Dict[str, Any]], str]]
) -> Callable[[Dict[str, Any]], str]:
    """Dispatch on request['workload'] (default 'latent') — one server
    fronting several model families."""

    def generate(req: Dict[str, Any]) -> str:
        w = str(req.get("workload", "latent"))
        if w not in routes:
            raise ValueError(f"unknown workload {w!r}; have {sorted(routes)}")
        return routes[w](req)

    return generate


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--svd-config", type=str, default=None,
                    help="also serve the SVD family (workload='svd')")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--model-size", type=str, default="full")
    ap.add_argument("--device", type=str, default="cuda")
    args, _ = ap.parse_known_args(argv)

    from animate_anything_tpu_torch import app, app_svd
    from animate_anything_tpu_torch.core.config import load_config

    cfg = load_config(args.config) if args.config else {}
    controller = app.AnimateController(
        pretrained_model_path=cfg.get("pretrained_model_path"),
        validation_data=cfg.get("validation_data"),
        model_size=cfg.get("model_size", args.model_size),
        attn_impl=cfg.get("attn_impl"), mixed_precision=cfg.get("mixed_precision", "bf16"),
        device=args.device,
    )
    routes = {"latent": controller_generate_fn(controller)}
    if args.svd_config:
        scfg = load_config(args.svd_config)
        routes["svd"] = svd_controller_generate_fn(app_svd.AnimateController(
            pretrained_model_path=scfg.get("pretrained_model_path"),
            validation_data=scfg.get("validation_data"),
            model_size=scfg.get("model_size", args.model_size),
            motion_mask=bool(scfg.get("motion_mask", True)), attn_impl=scfg.get("attn_impl"),
            mixed_precision=scfg.get("mixed_precision", "bf16"), device=args.device,
        ))
    server = VideoServer(multi_workload_generate_fn(routes), device=args.device)
    httpd = server.serve(args.port)
    print(f"serving on http://127.0.0.1:{args.port} (POST /generate)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()
        server.shutdown()


if __name__ == "__main__":
    main()
