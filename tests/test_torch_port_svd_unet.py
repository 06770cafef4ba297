"""The port's tiny SVD UNet (``models/svd_unet.py``) against the JAX
package's ``SVDUNetConfig.tiny()`` on the CPU in fp32, under the three
configurations (``"xla"``, ``"pallas"``, ``"packed"``) at 8 and 9 input
channels, b = 2 (CFG's halves: a zero context and an embedding). This
file holds the 9-channel (motion mask) UNet of the YAMLs;
``test_torch_port_svd_unet8.py`` runs the same tests at 8 channels.

The JAX side runs as its tests run it on the CPU: its Pallas flash kernel in
interpret mode (16×16 latents: the spatial self-attention at s = 256 takes
it under ``"pallas"``), its temporal conv, GEGLU tail and fused temporal
block through their exact twins; under ``"packed"`` both sides' frame
attention takes the einsum form off the card (JAX's packed kernel asks for
a TPU), so JAX's ``"packed"`` graph is its ``"xla"`` one: this file holds
the two equal bit for bit, and the 8-channel file compares the port's
``"packed"`` forward with JAX's ``"xla"`` output. The timestep is continuous
(0.25·log σ, not an integer) and the motion bucket 127 enters as an fp32
value. The JAX param tree is drawn with numpy from its ``eval_shape``
structure (the same tree under every ``attn_impl``) and carried into the
port with ``utils/convert.py::svd_unet_state_dict``, ``strict=True``.
Tolerance 5e-5 absolute on outputs of magnitude ~2: fp32 summation-order
noise through the ~150 layers (3.9e-6 measured on an x86 CPU), as
``test_torch_port_unet.py`` holds the UNet3D.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

ATOL = 5e-5
B, F, HW = 2, 3, 16


def _inputs(in_channels):
    r = np.random.default_rng(in_channels)
    ctx = r.standard_normal((B, 1, 32)).astype(np.float32)
    ctx[0] = 0.0
    return dict(sample=r.standard_normal((B, F, HW, HW, in_channels)).astype(np.float32),
                timestep=np.float32(0.25 * np.log(3.7)), context=ctx,
                added_time_ids=np.array([[6, 127, 0.02], [6, 127, 0.02]], np.float32))


def case_for(ch):
    """→ (channels, inputs, JAX params, the port's UNet with those weights)."""
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet

    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.convert import svd_unet_state_dict

    x = _inputs(ch)
    params = jax_params(JaxUNet(JaxCfg.tiny(in_channels=ch, attn_impl="xla")), *x.values())
    port = load_into(UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny(in_channels=ch)),
                     svd_unet_state_dict(params))
    return ch, x, params, port


@pytest.fixture(scope="module")
def case():
    return case_for(9)


@pytest.fixture(scope="module")
def jax_graph():
    """The JAX ``attn_impl`` whose forward each port configuration is held
    against."""
    return {"xla": "xla", "pallas": "pallas", "packed": "packed"}


@pytest.fixture(scope="module")
def jax_outputs(case):
    """JAX's forward under an ``attn_impl``, compiled once a module."""
    from animate_anything_tpu.models.svd_unet import SVDUNetConfig as JaxCfg
    from animate_anything_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JaxUNet

    ch, x, params, _ = case
    cache = {}

    def forward(impl):
        if impl not in cache:
            model = JaxUNet(JaxCfg.tiny(in_channels=ch, attn_impl=impl))
            with pltpu.force_tpu_interpret_mode():
                cache[impl] = np.asarray(jax.jit(model.apply)(params, *x.values()))
        return cache[impl]
    return forward


@pytest.mark.parametrize("impl", ["xla", "pallas", "packed"])
def test_tiny_svd_unet_matches_jax(case, jax_graph, jax_outputs, impl):
    _, x, _, port = case
    want = jax_outputs(jax_graph[impl])
    with torch.no_grad():
        got = port.with_attn_impl(impl)(*(t(v) for v in x.values()))
    assert got.shape == want.shape == (B, F, HW, HW, 4)
    np.testing.assert_allclose(n(got), want, atol=ATOL)


def test_jax_packed_is_the_xla_graph_off_the_tpu(jax_outputs):
    np.testing.assert_array_equal(jax_outputs("packed"), jax_outputs("xla"))


def test_timestep_is_continuous_and_the_ids_are_fp32(case):
    """0.25·log σ changes the output between two values that round to the
    same integer, and so does a motion bucket of 127.5 against 127."""
    _, x, _, port = case
    args = [t(v) for v in x.values()]
    with torch.no_grad():
        base = port(*args)
        nudged = port(args[0], torch.tensor(float(x["timestep"]) + 0.1), *args[2:])
        ids = args[3].clone()
        ids[:, 1] += 0.5
        bucket = port(*args[:3], ids)
    assert round(float(x["timestep"])) == round(float(x["timestep"]) + 0.1)
    assert float((nudged - base).abs().max()) > 1e-4
    assert float((bucket - base).abs().max()) > 1e-4
