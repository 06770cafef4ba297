"""The port's tiny mask+motion UNet forward against the JAX package's
``UNet3DConfig.tiny(motion_mask=True, motion_strength=True,
attn_impl="pallas")``, on the CPU, in fp32.

The JAX side runs its Pallas flash kernel in interpret mode (16x16 latents:
the spatial self-attention at s = 256 takes the kernel path). Two cases:
the fused temporal blocks (the main path: JAX's gate ``fused_ok`` holds for
every temporal transformer of the tiny UNet, and the JAX fused block runs
its exact reference off the TPU), and the composite temporal blocks, with
``fused_ok`` patched to False on both sides. The JAX param tree is drawn
with numpy from its ``eval_shape`` structure (the ``attn_impl="xla"`` tree
is the same) and carried into the port with ``utils/convert.py``, ``strict=True``.
Tolerance 5e-5 absolute on outputs of magnitude ~1: fp32 accumulation-order
noise through the ~100 stacked layers of the UNet (3.3e-6 measured on an
x86 CPU; the margin covers other BLAS summation orders).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import composite_temporal, jax_params, load_into, n, t

ATOL = 5e-5


def _jax_case(fused: bool):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg

    r = np.random.default_rng(0)
    b, f, hw = 2, 3, 16
    inputs = dict(
        sample=r.standard_normal((b, f, hw, hw, 4)).astype(np.float32),
        timestep=np.int32(721),
        context=r.standard_normal((b, 77, 32)).astype(np.float32),
        cond=r.standard_normal((b, 1, hw, hw, 4)).astype(np.float32),
        mask=(r.random((b, 1, hw, hw, 1)) > 0.5).astype(np.float32),
        motion=np.array([2.0, 8.0], np.float32),
    )
    args = tuple(inputs.values())
    jax_cfg = dict(motion_mask=True, motion_strength=True)
    params = jax_params(JaxUNet(JaxCfg.tiny(attn_impl="xla", **jax_cfg)), *args)
    model = JaxUNet(JaxCfg.tiny(attn_impl="pallas", **jax_cfg))
    path = contextlib.nullcontext() if fused else composite_temporal()
    with path, pltpu.force_tpu_interpret_mode():
        want = jax.jit(model.apply)(params, *args)
    return params, inputs, np.asarray(want)


@pytest.fixture(scope="module")
def case():
    return _jax_case(fused=False)


@pytest.fixture(scope="module")
def case_fused():
    return _jax_case(fused=True)


@pytest.fixture(scope="module")
def port_unet(case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    params, _, _ = case
    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True)
    return load_into(UNet3DConditionModel(cfg), unet3d_state_dict(params))


def _forward(unet, x):
    with torch.no_grad():
        return unet(t(x["sample"]), int(x["timestep"]), t(x["context"]), t(x["cond"]),
                    t(x["mask"]), t(x["motion"]))


def test_tiny_unet_forward_matches_jax_pallas_model(case, port_unet):
    """Composite temporal path on both sides."""
    _, x, want = case
    with composite_temporal():
        got = _forward(port_unet, x)
    assert got.shape == want.shape == x["sample"].shape
    np.testing.assert_allclose(n(got), want, atol=ATOL)


def test_tiny_unet_forward_fused_temporal_matches_jax(case_fused, port_unet):
    """The main path: fused temporal blocks (kernel 5's plain version and the
    tanh-GELU tail) against JAX's fused path on the same weights."""
    from animate_anything_tpu_torch.ops import temporal_block

    _, x, want = case_fused
    got = _forward(port_unet, x)
    assert temporal_block.fused_ok(4, 64, 8, 8)   # the tiny UNet's temporal sites take it
    assert got.shape == want.shape == x["sample"].shape
    np.testing.assert_allclose(n(got), want, atol=ATOL)


def test_tiny_unet_bf16_policy_stays_close(case, port_unet):
    """The bf16 compute policy (matrices bf16, norms and biases fp32) on the
    same weights: bf16 storage noise only, relative RMS within 5e-2."""
    import copy

    from animate_anything_tpu_torch.core.dtypes import cast_module_

    _, x, want = case
    half = cast_module_(copy.deepcopy(port_unet))
    assert all(p.dtype == (torch.bfloat16 if p.ndim >= 2 else torch.float32)
               for p in half.parameters())
    with composite_temporal():
        got = _forward(half, x).float()
    rel = float(np.sqrt(np.mean((n(got) - want) ** 2) / np.mean(want ** 2)))
    assert np.isfinite(n(got)).all() and rel < 5e-2, rel


def test_motion_strength_and_mask_change_the_output(case, port_unet):
    """Both conditioning inputs reach the output (guards against a silently
    dropped condition path)."""
    _, x, _ = case
    args = [t(x["sample"]), int(x["timestep"]), t(x["context"]), t(x["cond"])]
    with torch.no_grad():
        base = port_unet(*args, t(x["mask"]), t(x["motion"]))
        other_motion = port_unet(*args, t(x["mask"]), t(x["motion"]) + 3.0)
        other_mask = port_unet(*args, 1.0 - t(x["mask"]), t(x["motion"]))
    assert float((base - other_motion).abs().max()) > 1e-3
    assert float((base - other_mask).abs().max()) > 1e-3
