"""The port's headless controllers (``app.py``, ``app_svd.py``) and server
(``serving.py``) against the JAX package's root ``app.py``, ``app_svd.py``
and ``serving.py``, on the CPU.

The controllers' work is what they hand their pipeline: both sides'
controllers run on the same requests with a recording pipeline in place of
the model, and the recorded arguments must be equal (the alpha-mask rule,
an empty drawing animating everything, the /8 snap that keeps the area,
the strength times the mask's mean, the seed; for SVD the mask routing by
``in_channels``, the v2v route's frame count and first frame, the
guidance and micro-conditioning arguments). The pipelines themselves are
held against JAX in ``test_torch_port_pipeline.py`` and
``test_torch_port_svd_pipeline.py``.

The server runs one tiny-model request end to end through a
``ThreadingHTTPServer`` on port 0 (``/generate``, ``/jobs``, ``/result``,
``/healthz``), with the worker thread in inference mode; a repeated request
with the same seed returns the same gif bytes, and failing jobs (no image,
an unknown workload) end ``error`` with their message.
"""

import base64
import http.client
import io
import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_helpers import one_thread  # noqa: F401


class Recorder:
    """A pipeline that records its calls and returns a black video."""

    def __init__(self, torch_out: bool, frames: int = 2):
        self.calls, self.torch_out, self.frames = [], torch_out, frames

    def _video(self, h, w, f):
        video = np.zeros((1, f, h, w, 3), np.float32)
        return torch.from_numpy(video) if self.torch_out else video

    def animate_image(self, image, prompt, **kw):
        self.calls.append(dict(kw, image=np.asarray(image), prompt=prompt))
        return self._video(*np.asarray(image).shape[:2], kw["num_frames"]), None

    def __call__(self, image, **kw):
        self.calls.append(dict(kw, image=np.asarray(image)))
        return self._video(*np.asarray(image).shape[:2], kw["num_frames"]), None

    def video_to_condition_latent(self, video):
        f, h, w = np.asarray(video).shape[:3]
        z = np.zeros((1, f, h // 8, w // 8, 4), np.float32)
        return torch.from_numpy(z) if self.torch_out else z


def _controllers(jax_cls, port_cls, tmp_path, vd, **attrs):
    """Both controllers without their models: a Recorder each."""
    from animate_anything_tpu.core import Config as JaxConfig
    from animate_anything_tpu_torch.core.config import Config

    pair = []
    for cls, config, torch_out, name in ((jax_cls, JaxConfig, False, "jax"),
                                         (port_cls, Config, True, "port")):
        c = object.__new__(cls)
        c.validation_data, c.output_dir, c.sample_idx = config(vd), str(tmp_path / name), 0
        os.makedirs(c.output_dir, exist_ok=True)
        c.pipeline = Recorder(torch_out, vd.get("num_frames", 2))
        c.device = torch.device("cpu")
        for k, v in attrs.items():
            setattr(c, k, v)
        pair.append(c)
    return pair


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same_call(jax_call, port_call):
    assert set(jax_call) - {"rng"} == set(port_call) - {"generator"}
    for k, v in jax_call.items():
        if k == "rng":
            continue
        got = port_call[k]
        if isinstance(got, torch.Tensor):
            got = got.numpy()
        if isinstance(v, (np.ndarray, np.generic)) or hasattr(v, "shape"):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(v), err_msg=k)
        else:
            assert got == v, k


@pytest.mark.parametrize("case", ["partial_alpha", "empty_drawing", "plain_image"])
def test_latent_controller_matches_jax(case, tmp_path):
    import jax

    import app as jax_app
    from animate_anything_tpu_torch import app

    jc, pc = _controllers(jax_app.AnimateController, app.AnimateController, tmp_path,
                          {"num_frames": 2, "height": 64, "width": 64})
    image = _image(100, 60)
    layers = np.zeros((100, 60, 4), np.uint8)
    if case == "partial_alpha":
        layers[10:50, 5:30, 3] = 7          # any nonzero alpha moves
    init = image if case == "plain_image" else {"background": image, "layers": [layers]}
    for seed in (5, -1):
        for c in (jc, pc):
            c.animate(init, motion_scale=4.0, prompt="a thing moves", sample_steps=3,
                      cfg_scale=7.5, seed=seed)
    for j, p, seed in zip(jc.pipeline.calls, pc.pipeline.calls, (5, 1)):
        _same_call(j, p)
        # the area kept, snapped to /8: 100 x 60 → 64² at the same aspect
        assert p["image"].shape == (80, 48, 3) and p["mask_img"].shape == (80, 48)
        np.testing.assert_array_equal(np.asarray(j["rng"]),
                                      np.asarray(jax.random.PRNGKey(seed)))
        assert p["generator"].initial_seed() == seed
    mask = pc.pipeline.calls[0]["mask_img"]
    if case == "partial_alpha":
        assert 0 < mask.mean() < 255 and set(np.unique(mask)) == {0, 255}
        assert pc.pipeline.calls[0]["motion_strength"] == pytest.approx(4.0 * mask.mean() / 255)
    else:
        assert (mask == 255).all() and pc.pipeline.calls[0]["motion_strength"] == 4.0
    assert os.path.isfile(os.path.join(pc.output_dir, "1.gif")) and pc.sample_idx == 2


@pytest.mark.parametrize("case", ["mask", "no_mask", "eight_channels", "v2v"])
def test_svd_controller_matches_jax(case, tmp_path):
    import app_svd as jax_app_svd
    from animate_anything_tpu_torch import app_svd

    vd = {"num_frames": 3, "fps": 6, "motion_bucket_id": 100, "decode_chunk_size": 2}
    jc, pc = _controllers(jax_app_svd.AnimateController, app_svd.AnimateController, tmp_path,
                          vd, in_channels=8 if case == "eight_channels" else 9)
    image = _image(64, 48, 1)
    mask = np.where(np.random.default_rng(2).random((64, 48)) > 0.5, 255, 0).astype(np.uint8)
    video = np.stack([_image(64, 48, s) for s in range(5)]) if case == "v2v" else None
    for c in (jc, pc):
        c.animate(image, video_frames=video, mask_img=mask if case in ("mask", "v2v") else None,
                  steps=4, min_cfg=1.5, max_cfg=2.5, seed=9)
    (j,), (p,) = jc.pipeline.calls, pc.pipeline.calls
    _same_call(j, p)
    assert p["generator"].initial_seed() == 9
    if case == "eight_channels":
        assert p["mask"] is None
    else:
        assert tuple(p["mask"].shape) == (1, 1, 8, 6, 1)
        if case == "no_mask":
            assert (p["mask"] == 1).all()
    if case == "v2v":
        assert p["num_frames"] == 5 and (p["image"] == video[0]).all()
        assert tuple(p["condition_latent"].shape) == (1, 5, 8, 6, 4)


def _b64_png(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _request(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.read()


def _wait(port: int, job_id: str, timeout: float = 300.0) -> dict:
    t0 = time.time()
    while time.time() - t0 < timeout:
        status = json.loads(_request(port, "GET", f"/jobs/{job_id}")[1])
        if status["status"] in ("done", "error"):
            return status
        time.sleep(0.1)
    raise TimeoutError(job_id)


def test_server_answers_a_tiny_request_end_to_end(tmp_path):
    from animate_anything_tpu_torch import app
    from animate_anything_tpu_torch.serving import (VideoServer, controller_generate_fn,
                                                    multi_workload_generate_fn)

    controller = app.AnimateController(None, {"num_frames": 2, "height": 32, "width": 32},
                                       output_dir=str(tmp_path), model_size="tiny",
                                       mixed_precision="no", device="cpu")
    route = controller_generate_fn(controller)
    modes = []

    def latent(req):
        modes.append(torch.is_inference_mode_enabled())
        return route(req)

    server = VideoServer(multi_workload_generate_fn({"latent": latent}), device="cpu")
    httpd = server.serve(0)
    port = httpd.server_address[1]
    try:
        code, body = _request(port, "GET", "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        mask = np.zeros((40, 40, 3), np.uint8)
        mask[5:25, 10:30] = 255
        req = {"image_b64": _b64_png(_image(40, 40, 3)), "mask_b64": _b64_png(mask),
               "prompt": "a thing moves", "sample_steps": 2, "seed": 1}
        ids = []
        for body in (req, req, {"prompt": "no image"}, dict(req, workload="nope")):
            code, reply = _request(port, "POST", "/generate", body)
            assert code == 202
            ids.append(json.loads(reply)["job_id"])
        done = [_wait(port, i) for i in ids]
        assert [d["status"] for d in done] == ["done", "done", "error", "error"]
        assert "image_b64" in done[2]["error"] and "unknown workload" in done[3]["error"]
        assert done[0]["queue_seconds"] >= 0 and done[0]["generate_seconds"] > 0
        gifs = [_request(port, "GET", f"/result/{i}") for i in ids[:2]]
        assert [g[0] for g in gifs] == [200, 200] and gifs[0][1] == gifs[1][1]
        with Image.open(io.BytesIO(gifs[0][1])) as gif:
            assert gif.format == "GIF" and gif.n_frames == 2 and gif.size == (32, 32)
        assert _request(port, "GET", f"/result/{ids[2]}")[0] == 404
        assert _request(port, "GET", "/jobs/unknown")[0] == 404
        assert json.loads(_request(port, "GET", "/healthz")[1])["jobs_done"] == 2
        assert modes == [True] * 3  # the no-image job reached the route and raised there
    finally:
        httpd.shutdown()
        server.shutdown()


def test_ptp_controller_reaches_only_its_own_thread():
    """A prompt-to-prompt controller opened on one thread reroutes that
    thread's attention calls into the controlled branch, and no other
    thread's: a server's worker keeps its kernel route while a caller holds
    an ``AttentionStore`` open."""
    import threading

    from animate_anything_tpu_torch.ops import attention as attn
    from animate_anything_tpu_torch.utils import ptp

    q = torch.randn(1, 130, 2, 16, generator=torch.Generator().manual_seed(0))
    store, seen = ptp.AttentionStore(), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn, "flash_attention", lambda *a, **k: seen.append("pallas") or a[0])
        with ptp.attention_control(store):
            worker = threading.Thread(target=lambda: seen.append(
                ("worker", ptp.active_controller(), attn.attention(q, q, q) is q)))
            worker.start()
            worker.join()
            own = attn.attention(q, q, q, tag=(("down_blocks", "0"), False))
        assert ptp.active_controller() is None
    assert seen == ["pallas", ("worker", None, True)]
    torch.testing.assert_close(own, attn.attention_reference(q, q, q), rtol=1e-5, atol=1e-5)
    (mine,) = store.step_store["down_self"]
    assert mine.shape == (2, 130, 130)
