"""The port's tiny mask+motion UNet forward against the JAX package's
``UNet3DConfig.tiny(motion_mask=True, motion_strength=True,
attn_impl="pallas")``, on the CPU, in fp32.

The JAX side runs its Pallas flash kernel in interpret mode (16x16 latents:
the spatial self-attention at s = 256 takes the kernel path) and, like the
port's slice, the composite temporal blocks: ``fused_ok`` is patched to
False for this module only. The JAX param tree is drawn with numpy from its
``eval_shape`` structure (the ``attn_impl="xla"`` tree is the same) and
carried into the port with ``utils/convert.py``, ``strict=True``.
Tolerance 5e-5 absolute on outputs of magnitude ~1: fp32 accumulation-order
noise through the ~100 stacked layers of the UNet (3.3e-6 measured on an
x86 CPU; the margin covers other BLAS summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, t

ATOL = 5e-5


@pytest.fixture(scope="module")
def case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.ops import temporal_block

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
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(temporal_block, "fused_ok", lambda *a, **k: False)
        want = jax.jit(model.apply)(params, *args)
    return params, inputs, np.asarray(want)


@pytest.fixture(scope="module")
def port_unet(case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    params, _, _ = case
    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True)
    return load_into(UNet3DConditionModel(cfg), unet3d_state_dict(params))


def test_tiny_unet_forward_matches_jax_pallas_model(case, port_unet):
    _, x, want = case
    with torch.no_grad():
        got = port_unet(t(x["sample"]), int(x["timestep"]), t(x["context"]), t(x["cond"]),
                        t(x["mask"]), t(x["motion"]))
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
    with torch.no_grad():
        got = half(t(x["sample"]), int(x["timestep"]), t(x["context"]), t(x["cond"]),
                   t(x["mask"]), t(x["motion"])).float()
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
