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
