"""The port's LaMa (``animate_anything_tpu_torch/models/lama.py``) against the
JAX package's, on the CPU, in fp32, at the tiny config of
``tests/test_ptp_lama.py`` (ngf 8, 2 downsamplings, 2 blocks, 32 px).

The JAX modules are applied eagerly (no ``jit``). Each port module draws its
weights with ``init_lama_`` (BatchNorm running statistics randomized), and
JAX reads them through its own importers (``_fourier_unit``, ``_spectral``,
``_ffc``, ``_ffc_bn_act``, ``import_lama_torch_state``), so the published
key layout and the interleaved Fourier channels are held without the torch
reference. The other way, ``utils/convert.lama_state_dict`` carries JAX's
params into the port with ``strict=True``.

Tolerance: 1e-5 absolute on outputs of order 1 (fp32; the two FFT libraries
and the convs' summation order differ in the last bits). uint8 videos: within
1 (a 1e-6 difference can cross a truncation boundary), and exactly the input
outside the mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animate_anything_tpu.models import lama as jlama
from animate_anything_tpu_torch.models import lama as plama
from animate_anything_tpu_torch.utils.convert import init_lama_, lama_state_dict
from test_torch_port_helpers import one_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _tiny():
    return dict(ngf=8, n_downsampling=2, n_blocks=2, max_features=32)


def _init(module, seed=0):
    return init_lama_(module.eval(), torch.Generator().manual_seed(seed))


def _sd(module, prefix="m"):
    return {f"{prefix}.{k}": v.numpy() for k, v in module.state_dict().items()}


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_fourier_unit_matches_jax():
    m = _init(plama.FourierUnit(6, 6))
    x = _x((2, 6, 12, 10))
    params = {"params": jlama._fourier_unit(_sd(m), "m")}
    want = jlama.FourierUnit(6).apply(params, jnp.asarray(_nhwc(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_spectral_transform_matches_jax(stride):
    m = _init(plama.SpectralTransform(6, 8, stride))
    x = _x((2, 6, 16, 12))
    params = {"params": jlama._spectral(_sd(m), "m")}
    want = jlama.SpectralTransform(8, stride=stride).apply(params, jnp.asarray(_nhwc(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


# (ratio_gin, ratio_gout, stride): l2l alone; l2l + l2g; l2l + g2l; all four;
# all four at stride 2 (g2g's pooled spectral transform); the downsampling
# layer's split (global output from a local input)
FFC_CASES = [(0.0, 0.0, 1), (0.0, 0.5, 1), (0.5, 0.0, 1), (0.5, 0.5, 1), (0.75, 0.75, 2),
             (0.0, 0.75, 2)]


@pytest.mark.parametrize("gin,gout,stride", FFC_CASES)
def test_ffc_paths_match_jax(gin, gout, stride):
    m = _init(plama.FFCBnAct(8, 8, 3, gin, gout, stride, padding=1))
    x = _x((2, 8, 16, 16))
    cg = int(8 * gin)
    x_l, x_g = x[:, :8 - cg], (x[:, 8 - cg:] if cg else None)
    paths = {k.split(".")[1] for k in m.state_dict() if k.startswith("ffc.")}
    want_paths = {"convl2l"} | ({"convl2g"} if gout else set()) | \
        ({"convg2l"} if gin else set()) | ({"convg2g"} if gin and gout else set())
    assert paths == want_paths
    params = {"params": jlama._ffc_bn_act(_sd(m), "m")}
    j_in = (jnp.asarray(_nhwc(x_l)), None if x_g is None else jnp.asarray(_nhwc(x_g)))
    w_l, w_g = jlama.FFCBnAct(8, 8, 3, gin, gout, stride, 1).apply(params, j_in)
    with torch.no_grad():
        g_l, g_g = m((torch.from_numpy(x_l), None if x_g is None else torch.from_numpy(x_g)))
    for got, want in ((g_l, w_l), (g_g, w_g)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_ffc_resnet_block_matches_jax():
    m = _init(plama.FFCResnetBlock(16))
    x = _x((2, 16, 16, 16))
    sd = _sd(m)
    params = {"params": {h: jlama._ffc_bn_act(sd, f"m.{h}") for h in ("conv1", "conv2")}}
    j_in = (jnp.asarray(_nhwc(x[:, :4])), jnp.asarray(_nhwc(x[:, 4:])))
    w_l, w_g = jlama.FFCResnetBlock(16).apply(params, j_in)
    with torch.no_grad():
        g_l, g_g = m((torch.from_numpy(x[:, :4]), torch.from_numpy(x[:, 4:])))
    np.testing.assert_allclose(_nhwc(g_l), np.asarray(w_l), atol=ATOL)
    np.testing.assert_allclose(_nhwc(g_g), np.asarray(w_g), atol=ATOL)


def _inputs():
    r = np.random.default_rng(0)
    img = r.random((2, 3, 32, 32), np.float32)
    mask = np.zeros((2, 1, 32, 32), np.float32)
    mask[:, :, 8:20, 4:16] = 1.0
    return img, mask


def test_large_mask_inpainting_through_the_published_layout_matches_jax():
    """The port's own state dict, read by JAX's ``import_lama_torch_state``,
    gives JAX's module the port's output; the published keys load back with
    ``strict=True``."""
    cfg = plama.LamaConfig(**_tiny())
    m = _init(plama.LargeMaskInpainting(cfg))
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    assert "model.1.ffc.convl2l.weight" in sd
    assert "model.5.conv1.ffc.convg2g.fu.conv_layer.weight" in sd
    params = jlama.import_lama_torch_state(sd, jlama.LamaConfig(**_tiny()))
    img, mask = _inputs()
    want = jlama.LargeMaskInpainting(jlama.LamaConfig(**_tiny())).apply(
        params, jnp.asarray(_nhwc(img)), jnp.asarray(_nhwc(mask)))
    with torch.no_grad():
        got = m(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    again = plama.LargeMaskInpainting(cfg)
    again.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)


def _jax_params(cfg, seed=3):
    img, mask = _inputs()
    params = jlama.LargeMaskInpainting(cfg).init(
        jax.random.PRNGKey(seed), jnp.asarray(_nhwc(img)), jnp.asarray(_nhwc(mask)))
    # running statistics that do work, as the import test of the JAX package draws them
    r = np.random.default_rng(seed)

    def bn(tree):
        if isinstance(tree, dict) and "mean" in tree and "var" in tree:
            return {**tree, "mean": r.normal(0, 0.1, tree["mean"].shape).astype(np.float32),
                    "var": r.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)}
        if isinstance(tree, dict):
            return {k: bn(v) for k, v in tree.items()}
        return tree

    return {"params": bn(jax.tree_util.tree_map(np.asarray, params["params"]))}


def test_jax_params_load_into_the_port_with_strict_keys():
    cfg = jlama.LamaConfig(**_tiny())
    params = _jax_params(cfg)
    m = plama.LargeMaskInpainting(plama.LamaConfig(**_tiny())).eval()
    m.load_state_dict(lama_state_dict(params, plama.LamaConfig(**_tiny())), strict=True)
    img, mask = _inputs()
    want = jlama.LargeMaskInpainting(cfg).apply(params, jnp.asarray(_nhwc(img)),
                                                jnp.asarray(_nhwc(mask)))
    with torch.no_grad():
        got = m(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_inpaint_video_matches_jax(monkeypatch):
    cfg = jlama.LamaConfig(**_tiny())
    params = _jax_params(cfg, seed=4)
    m = plama.LargeMaskInpainting(plama.LamaConfig(**_tiny()))
    m.load_state_dict(lama_state_dict(params, plama.LamaConfig(**_tiny())), strict=True)
    r = np.random.default_rng(5)
    video = (r.random((3, 32, 32, 3)) * 255).astype(np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[8:16, 10:24] = 255
    monkeypatch.setattr(jlama.jax, "jit", lambda f: f)        # eager, no compile
    want = jlama.inpaint_video(video, mask, params, model=jlama.LargeMaskInpainting(cfg),
                               chunk=2)
    got = plama.inpaint_video(video, mask, m, chunk=2, device="cpu")
    assert got.dtype == np.uint8 and got.shape == video.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    outside = mask < 128
    np.testing.assert_array_equal(got[:, outside], video[:, outside])
    assert np.abs(got[:, ~outside].astype(int) - video[:, ~outside].astype(int)).max() > 0


def test_inpaint_video_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = plama.LargeMaskInpainting(plama.LamaConfig(**_tiny()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plama.inpaint_video(np.zeros((1, 32, 32, 3), np.uint8), np.zeros((32, 32)), m)


def test_full_config_parameter_shapes_match_jax():
    """``LamaConfig()`` (ngf 64, 3 downsamplings, 18 blocks): JAX's
    ``eval_shape`` tree through ``lama_state_dict`` has the port's keys and
    shapes."""
    shapes = jax.eval_shape(
        lambda: jlama.LargeMaskInpainting().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1))))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    sd = lama_state_dict(zeros)
    with torch.device("meta"):
        port = plama.LargeMaskInpainting()
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sum(int(np.prod(s)) for k, s in want.items()
               if not k.endswith("num_batches_tracked")) > 27_000_000


def test_cli_writes_what_inpaint_video_returns(tmp_path):
    from PIL import Image

    from animate_anything_tpu_torch.utils import media

    m = _init(plama.LargeMaskInpainting(plama.LamaConfig(**_tiny())))
    ckpt = tmp_path / "best.ckpt"
    torch.save({"state_dict": {f"generator.{k}": v for k, v in m.state_dict().items()}}, ckpt)
    r = np.random.default_rng(6)
    video = (r.random((3, 32, 32, 3)) * 255).astype(np.uint8)
    media.save_gif(str(tmp_path / "clip.gif"), video, fps=4)
    mask = np.zeros((32, 32), np.uint8)
    mask[4:12, 4:28] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    out = plama._main([str(tmp_path / "clip.gif"), str(tmp_path / "mask.png"), str(ckpt),
                       "--out", str(tmp_path / "out.gif"), "--device", "cpu"],
                      cfg=plama.LamaConfig(**_tiny()))
    frames = media.load_video_frames(str(tmp_path / "clip.gif"))
    want = media.save_gif(str(tmp_path / "want.gif"),
                          plama.inpaint_video(frames, mask, m, device="cpu"), fps=8)
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
