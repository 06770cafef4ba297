"""Shared helpers for the tests that hold the PyTorch port against the JAX
package (no tests here).

Both sides get the same inputs and weights, made with numpy from a seed:
JAX param trees are drawn from their ``eval_shape`` structure (no init
compile), and carried into the port with ``utils/convert.py`` and
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def jax_params(module, *args, seed: int = 0):
    """A deterministic param tree for a flax module: unit-ish norm scales,
    small biases, kernels ~ N(0, 1/fan_in). Arguments without a shape (frame
    counts, flags) stay static."""
    traced = [i for i, a in enumerate(args) if hasattr(a, "shape")]

    def init(rng, *arrays):
        full = list(args)
        for i, a in zip(traced, arrays):
            full[i] = a
        return module.init(rng, *full)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *[args[i] for i in traced])
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the many tiny CPU ops of a port test: beside
    the other test workers, a thread pool per op costs more than it
    computes. Autouse in every module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x) -> torch.Tensor:
    """numpy / jax array → torch tensor (CPU)."""
    return torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """torch tensor / jax array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x)


def load_into(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    return module.eval()


def port_state_dict(params, prefix: str = ""):
    """JAX subtree → port state dict; ``prefix`` wraps the tree under a parent
    name (the temporal-conv renames key on ``temp_convs``) and is stripped."""
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    tree = params["params"]
    if not prefix:
        return unet3d_state_dict(tree)
    sd = unet3d_state_dict({prefix: tree})
    head = prefix.replace("_", ".") + "."
    return {k[len(head):]: v for k, v in sd.items()}


def jax_tiny_models(motion_mask=True):
    """The JAX package's tiny UNet (``attn_impl="xla"``), VAE and CLIP text
    encoder with ``jax_params`` weights, as ``build_models`` returns them."""
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.models.clip_text import CLIPTextConfig as JaxCLIPCfg
    from animate_anything_tpu.models.clip_text import CLIPTextModel as JaxCLIP
    from animate_anything_tpu.models.vae import AutoencoderKL as JaxVAE
    from animate_anything_tpu.models.vae import VAEConfig as JaxVAECfg

    ucfg = JaxCfg.tiny(motion_mask=motion_mask, motion_strength=True, attn_impl="xla")
    z = np.zeros((1, 1, 4, 4, 4), np.float32)
    args = (z, np.int32(1), np.zeros((1, 77, 32), np.float32), z)
    args += (z[..., :1],) if motion_mask else (None,)
    uparams = jax_params(JaxUNet(ucfg), *args, np.ones(1, np.float32))
    vcfg, tcfg = JaxVAECfg.tiny(), JaxCLIPCfg.tiny(hidden_size=32)
    vparams = jax_params(JaxVAE(vcfg), jnp.zeros((1, 32, 32, 3)), seed=1)
    tparams = jax_params(JaxCLIP(tcfg), np.zeros((1, 16), np.int32), seed=2)
    return dict(unet=JaxUNet(ucfg), unet_params=uparams, unet_config=ucfg, vae=JaxVAE(vcfg),
                vae_params=vparams, vae_config=vcfg, text=JaxCLIP(tcfg), text_params=tparams,
                text_config=tcfg)


def save_jax_pipeline(models, path):
    """``jax_tiny_models``' weights through JAX's ``save_pipeline`` → the
    directory's path."""
    from animate_anything_tpu.train.checkpoint import save_pipeline

    save_pipeline(str(path), models["unet_params"], models["unet_config"],
                  models["vae_params"], models["vae_config"], models["text_params"],
                  models["text_config"])
    return str(path)


@contextlib.contextmanager
def composite_temporal():
    """Both sides on the composite temporal path: JAX's gate ``fused_ok`` and
    the port's copy of it (as ``models/attention.py`` uses it) answer False."""
    from animate_anything_tpu.ops import temporal_block
    from animate_anything_tpu_torch.models import attention

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(temporal_block, "fused_ok", lambda *a, **k: False)
        mp.setattr(attention, "fused_ok", lambda *a, **k: False)
        yield
