"""The full-width SVD UNet (``SVDUNetConfig(in_channels=9)``: 320/640/1280/
1280 channels, heads 5/10/20/20, cross dim 1024) on both sides, on the CPU
in fp32, at a small spatial and frame size (128 px, a 16 × 16 latent, 2
frames, batch 1): the comparison that reaches the 640- and 1280-wide sites
(kernel 2 at c = 1280, kernel 5 at 20 heads) with values on both sides.

Slow tier: each side's parameters take ~6 GB, and JAX compiles the
full-width graph (with the Pallas flash kernel in interpret mode under
``"pallas"``). Compared under ``"xla"``, then under ``"pallas"`` (kernel
5's plain version against JAX's fused block), as
``test_torch_port_full_width.py`` holds the UNet3D. Tolerance: the tiny
SVD tests' 5e-5 absolute on outputs of magnitude ~2 (fp32 summation-order
noise).
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
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet

    r = np.random.default_rng(0)
    inputs = dict(sample=r.standard_normal((1, FRAMES, HW, HW, 9)).astype(np.float32),
                  timestep=np.float32(0.25 * np.log(12.5)),
                  context=r.standard_normal((1, 1, 1024)).astype(np.float32),
                  added_time_ids=np.array([[6.0, 127.0, 0.02]], np.float32))
    params = jax_params(JaxUNet(JaxCfg(in_channels=9, attn_impl="xla")), *inputs.values())
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    gc.collect()
    return params, inputs


@pytest.fixture(scope="module")
def port_unet(case):
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import svd_unet_state_dict

    with torch.device("meta"):
        unet = UNetSpatioTemporalConditionModel(SVDUNetConfig(in_channels=9))
    unet.load_state_dict(svd_unet_state_dict(case[0]), strict=True, assign=True)
    gc.collect()
    return unet.eval()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_full_width_svd_unet_forward_matches_jax(case, port_unet, impl):
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet

    params, x = case
    assert sum(p.numel() for p in port_unet.parameters()) > 1.4e9
    model = JaxUNet(JaxCfg(in_channels=9, attn_impl=impl))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(model.apply)(params, *x.values()))
    with torch.no_grad():
        got = n(port_unet.with_attn_impl(impl)(*(t(v) for v in x.values())))
    assert got.shape == want.shape == (1, FRAMES, HW, HW, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
