"""Gradients of the port's modules against ``jax.grad`` of the JAX package's,
on the CPU, in fp32.

Each module runs on both sides with one numpy-drawn JAX param tree (carried
into the port by ``utils/convert.py``), the same inputs and the same random
cotangents for every output, the GroupNorm sums included: the sums feed the
next GroupNorm, so their cotangent is not zero. Compared: the gradient of
every input (the producer's sums too, which ``group_affine(sums=...)``
passes back) and of every parameter, the JAX tree's carried over by the same
key map. The JAX side runs ``attn_impl="pallas"`` (flash attention's Pallas
forward and backward in interpret mode; off the TPU its fused temporal
block, LN+GEGLU, tap-conv and projection wrappers take their XLA twins,
which are what their custom VJPs differentiate on the TPU). The port's CPU
path runs its autograd Functions with the plain versions forward and the
torch twins backward.

Tolerance 5e-5 absolute: fp32 accumulation-order noise. The cotangents are
scaled (1/sqrt(rows) for an output, 1/rows for its sums) so parameter
gradients, sums over every row, stay near unit scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_port_helpers as helpers
from test_torch_port_helpers import jax_params, load_into, n, port_state_dict, t

ATOL = 5e-5


def _cotangents(out, rng):
    """A random cotangent per output leaf: N(0, 1)/sqrt(R) for the output of
    R rows, N(0, 1)/R for its sums."""
    leaves, tree = jax.tree_util.tree_flatten(out)
    rows = leaves[0].size // leaves[0].shape[-1]
    cots = [rng.standard_normal(a.shape) / (np.sqrt(rows) if i == 0 else rows)
            for i, a in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(tree, [c.astype(np.float32) for c in cots])


def _sums(x2):
    """Per-row fp32 (Σx, Σx²) over the middle axes of x (n, ..., c)."""
    xf = x2.reshape(x2.shape[0], -1, x2.shape[-1])
    return xf.sum(1), (xf * xf).sum(1)


def _check(jax_fn, params, inputs, port_module, port_call, prefix="", seed=0):
    """jax.vjp of ``jax_fn(params, *inputs)`` against the port's autograd of
    ``port_call(port_module, *inputs)`` for the same output cotangents."""
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    want_out, vjp = jax.vjp(jax_fn, params, *jin)
    cot = _cotangents(want_out, np.random.default_rng(seed + 100))
    want_gp, *want_gin = vjp(jax.tree_util.tree_map(jnp.asarray, cot))

    port = load_into(port_module, port_state_dict(params, prefix))
    tin = jax.tree_util.tree_map(lambda a: t(a).requires_grad_(True), inputs)
    got_out = port_call(port, *tin)
    flat_got, flat_want = jax.tree_util.tree_leaves(got_out), jax.tree_util.tree_leaves(want_out)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-3 if g.ndim == 2 else ATOL)
    loss = sum((g * t(c)).sum() for g, c in zip(flat_got, jax.tree_util.tree_leaves(cot)))
    loss.backward()

    for i, (g, w) in enumerate(zip(jax.tree_util.tree_leaves(tin),
                                   jax.tree_util.tree_leaves(want_gin))):
        np.testing.assert_allclose(n(g.grad), n(w), atol=ATOL, err_msg=f"input {i}")
    want_p = port_state_dict(want_gp, prefix)
    named = dict(port.named_parameters())
    assert set(want_p) == set(named)
    for name, w in want_p.items():
        got = named[name].grad
        assert got is not None, name
        np.testing.assert_allclose(n(got), n(w), atol=ATOL, err_msg=name)


def test_resnet_block_grads_match_jax():
    from animate_anything_tpu.models.layers import ResnetBlock2D as JaxResnet
    from animate_anything_tpu_torch.models.layers import ResnetBlock2D

    r = np.random.default_rng(0)
    x = r.standard_normal((4, 8, 8, 32)).astype(np.float32)
    temb = r.standard_normal((4, 64)).astype(np.float32)
    jm = JaxResnet(64, groups=8)
    p = jax_params(jm, x, temb)
    _check(lambda p, x, temb: jm.apply(p, x, temb), p, (x, temb),
           ResnetBlock2D(32, 64, 64, groups=8), lambda m, x, temb: m(x, temb))


def test_temporal_conv_layer_grads_match_jax_with_in_sums():
    """The producer's sums enter stage 1's GroupNorm; their gradient (and the
    three Σ/Σ² cotangents between the four kernel-3 stages) must match."""
    from animate_anything_tpu.models.layers import TemporalConvLayer as JaxTConv
    from animate_anything_tpu_torch.models.layers import TemporalConvLayer

    r = np.random.default_rng(1)
    f = 5
    x = r.standard_normal((2 * f, 4, 4, 64)).astype(np.float32)
    in_sums = _sums(x)
    jm = JaxTConv(64, impl="pallas")
    p = jax_params(jm, x, f)
    _check(lambda p, x, s: jm.apply(p, x, f, True, True, s), p, (x, in_sums),
           TemporalConvLayer(64), lambda m, x, s: m(x, f, s), prefix="temp_convs_0")


def test_spatial_transformer_grads_match_jax():
    """Flash attention at s = 256 (its Pallas backward, lanes kernels), the
    LN+GEGLU tail and the projection with its sums; entry sums in."""
    from animate_anything_tpu.models.attention import SpatialTransformer as JaxST
    from animate_anything_tpu_torch.models.attention import SpatialTransformer

    r = np.random.default_rng(2)
    c, heads, d = 128, 2, 64
    x = r.standard_normal((2, 16, 16, c)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 32)).astype(np.float32)
    p = jax_params(JaxST(heads, d, 32, attn_impl="xla"), x, ctx)
    jm = JaxST(heads, d, 32, attn_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        _check(lambda p, x, ctx, s: jm.apply(p, x, ctx, None, s, True), p,
               (x, ctx, _sums(x)), SpatialTransformer(c, heads, d, 32),
               lambda m, x, ctx, s: m(x, ctx, s))


@pytest.mark.parametrize("path,heads,c", [("fused", 2, 64), ("composite", 2, 64),
                                          ("fused", 8, 32)],
                         ids=["fused", "composite", "transformer_in"])
def test_temporal_transformer_grads_match_jax(path, heads, c):
    from animate_anything_tpu.models.attention import TemporalTransformer as JaxTT
    from animate_anything_tpu_torch.models.attention import TemporalTransformer

    r = np.random.default_rng(3)
    f, d = 5, 8 if c == 32 else 32
    x = r.standard_normal((2 * f, 4, 4, c)).astype(np.float32)
    folded = tuple(s.reshape(2, f, c).sum(1) for s in _sums(x))
    p = jax_params(JaxTT(heads, d, attn_impl="xla"), x, f)
    jm = JaxTT(heads, d, attn_impl="pallas")

    def run():
        _check(lambda p, x, s: jm.apply(p, x, f, None, s, True), p, (x, folded),
               TemporalTransformer(c, heads, d), lambda m, x, s: m(x, f, s))

    if path == "composite":
        with helpers.composite_temporal():
            run()
    else:
        run()


def test_gradient_checkpointing_gives_the_same_gradients():
    """Per-sub-layer checkpointing re-runs each sub-layer's forward in the
    backward; the tiny UNet's every gradient is the same as without it."""
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    grads = []
    for remat in (False, True):
        cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True, attn_impl="pallas",
                                gradient_checkpointing=remat)
        gen = torch.Generator().manual_seed(0)
        model = init_unet3d_(UNet3DConditionModel(cfg), gen)
        for name, p in model.named_parameters():
            if "conv4.3" in name:
                p.data.normal_(0.0, 0.02, generator=gen)
        r = np.random.default_rng(4)
        sample = t(r.standard_normal((1, 2, 16, 16, 4)).astype(np.float32))
        cond = t(r.standard_normal((1, 1, 16, 16, 4)).astype(np.float32))
        mask = t((r.random((1, 1, 16, 16, 1)) > 0.5).astype(np.float32))
        ctx = t(r.standard_normal((1, 7, 32)).astype(np.float32))
        out = model(sample, torch.tensor([321]), ctx, cond, mask, torch.tensor([4.0]))
        (out * t(r.standard_normal(out.shape).astype(np.float32))).sum().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert all(g is not None for g in grads[0].values())
    for name, g in grads[0].items():
        np.testing.assert_allclose(n(grads[1][name]), n(g), atol=1e-6, err_msg=name)
