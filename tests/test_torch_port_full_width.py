"""The full-width mask+motion UNet (``UNet3DConfig(motion_mask=True,
motion_strength=True)``: 320/640/1280/1280 channels, 1.41 B parameters) on
both sides, on the CPU in fp32, at a small spatial and frame size (128 px,
a 16 x 16 latent, 2 frames, batch 1): the first comparison that reaches the
640- and 1280-wide sites with values on both sides.

Slow tier: each side's parameters take ~5.6 GB, and JAX compiles the
full-width graph (with the Pallas kernels in interpret mode under
``"pallas"``). Compared under ``"xla"`` on both sides, then under
``"pallas"`` (the fused temporal path on both sides, as the tiny tests run
it). Tolerance: the tiny UNet tests' 5e-5 absolute, on an output of RMS
0.64 and magnitude up to 2.24 (fp32 summation-order noise; measured 8.4e-6
under "xla" and 7.0e-6 under "pallas").
"""

import gc

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, n, t

pytestmark = pytest.mark.slow

ATOL = 5e-5
FRAMES, HW = 2, 16


@pytest.fixture(scope="module")
def case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg

    r = np.random.default_rng(0)
    inputs = dict(
        sample=r.standard_normal((1, FRAMES, HW, HW, 4)).astype(np.float32),
        timestep=np.int32(601),
        context=r.standard_normal((1, 77, 1024)).astype(np.float32),
        cond=r.standard_normal((1, 1, HW, HW, 4)).astype(np.float32),
        mask=(r.random((1, 1, HW, HW, 1)) > 0.5).astype(np.float32),
        motion=np.array([5.0], np.float32),
    )
    params = jax_params(JaxUNet(JaxCfg(motion_mask=True, motion_strength=True, attn_impl="xla")),
                        *inputs.values())
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    gc.collect()
    return params, inputs


@pytest.fixture(scope="module")
def port_unet(case):
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig(motion_mask=True, motion_strength=True))
    unet.load_state_dict(unet3d_state_dict(case[0]), strict=True, assign=True)
    gc.collect()
    return unet.eval()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_full_width_unet_forward_matches_jax(case, port_unet, impl):
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg

    params, x = case
    assert sum(p.numel() for p in port_unet.parameters()) > 1.4e9
    model = JaxUNet(JaxCfg(motion_mask=True, motion_strength=True, attn_impl=impl))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(model.apply)(params, *x.values()))
    unet = port_unet.with_attn_impl(impl)
    with torch.no_grad():
        got = n(unet(t(x["sample"]), int(x["timestep"]), t(x["context"]), t(x["cond"]),
                     t(x["mask"]), t(x["motion"])))
    assert got.shape == want.shape == x["sample"].shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"full-width UNet, attn_impl={impl!r}: max |port - jax| {err:.3g}, "
          f"max |jax| {np.abs(want).max():.3g}, RMS {np.sqrt(np.mean(want ** 2)):.3g}")
    np.testing.assert_allclose(got, want, atol=ATOL)
