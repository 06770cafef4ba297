"""The port's GroupNorm switches, kernel 6 (channel sums) and kernel 7 (the
one-pass GroupNorm) against the JAX package, on the CPU, in fp32.

The JAX side runs its Pallas kernels in interpret mode: ``_pallas_channel_sums``
(``ops/group_norm.py``) and ``_pallas_group_norm``
(``ops/attic/streaming_group_norm.py``); the port runs their plain versions,
which is what its wrappers take for CPU tensors. Tolerances: the channel sums
differ only in summation order (relative 1e-6); the GroupNorm outputs are
held at 1e-5 absolute, as the JAX package holds its kernel against its
composite path. The switches are module state, so every test that flips one
restores it in ``finally`` (an xdist worker keeps module state across the
tests of a file).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import n, t


@contextlib.contextmanager
def switches(norm="xla", stats="xla"):
    """Both packages' GroupNorm switches, restored to "xla" on exit."""
    from animate_anything_tpu.ops import group_norm as jgn
    from animate_anything_tpu_torch.ops import group_norm as gn

    try:
        for mod in (jgn, gn):
            mod.set_default_norm_impl(norm)
            mod.set_default_stats_impl(stats)
        yield
    finally:
        for mod in (jgn, gn):
            mod.set_default_norm_impl("xla")
            mod.set_default_stats_impl("xla")


def _x(shape, seed=0, scale=2.0, shift=0.3):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) * scale + shift).astype(np.float32)


def _affine(c, seed=1):
    r = np.random.default_rng(seed)
    return ((1.0 + 0.1 * r.standard_normal(c)).astype(np.float32),
            (0.1 * r.standard_normal(c)).astype(np.float32))


@pytest.mark.parametrize("shape", [(3, 64, 320), (2, 48, 128)])
def test_channel_sums_match_the_pallas_kernel(shape):
    from animate_anything_tpu.ops.group_norm import _pallas_channel_sums
    from animate_anything_tpu_torch.ops.group_norm import stream_channel_sums

    x = _x(shape)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_channel_sums(jnp.asarray(x))
    got = stream_channel_sums(t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-6, atol=1e-6 * float(np.abs(w).max()))


def test_channel_sums_gradient_matches_the_custom_vjp():
    from animate_anything_tpu.ops.group_norm import _pallas_channel_sums
    from animate_anything_tpu_torch.ops.group_norm import stream_channel_sums

    x = _x((2, 40, 96))
    r = np.random.default_rng(5)
    g1, g2 = (r.standard_normal((2, 96)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(_pallas_channel_sums, jnp.asarray(x))
        (want,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    xt = t(x).requires_grad_(True)
    s1, s2 = stream_channel_sums(xt)
    torch.autograd.backward([s1, s2], [t(g1), t(g2)])
    np.testing.assert_allclose(n(xt.grad), n(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl,rows,want", [("xla", 64, False), ("pallas", 64, True),
                                            ("pallas", 7, False), ("pallas", 12, False)])
def test_stats_gate_matches_jax(impl, rows, want):
    """``stats_ok`` is JAX's gate: the switch, then an aligned row chunk (a
    prime row count, or one with no multiple-of-8 divisor, is ineligible)."""
    from animate_anything_tpu.ops import group_norm as jgn
    from animate_anything_tpu_torch.ops import group_norm as gn

    with switches(stats=impl):
        got_jax = jgn.stats_ok(jnp.zeros((2, rows, 320), jnp.bfloat16))
        got = gn.stats_ok(torch.zeros(2, rows, 320, dtype=torch.bfloat16))
    assert got == got_jax == want


def test_stats_auto_takes_the_kernel_path_for_every_tensor():
    """The port's "auto" is "pallas": the kernel for CUDA tensors, its plain
    version for CPU tensors (JAX's "auto" checks for a TPU instead)."""
    from animate_anything_tpu_torch.ops import group_norm as gn

    with switches(stats="auto"):
        assert gn.stats_ok(torch.zeros(2, 64, 320))
    with pytest.raises(ValueError):
        gn.set_default_stats_impl("cuda")
    with pytest.raises(ValueError):
        gn.set_default_norm_impl("auto")
    assert gn._DEFAULT_STATS == gn._DEFAULT_IMPL == "xla"


def test_group_affine_under_the_stats_switch_matches_jax():
    """Both sides route the statistics through their channel-sums kernel
    (counted), and the folded (a, b) agree."""
    from animate_anything_tpu.ops import group_norm as jgn
    from animate_anything_tpu_torch.ops import group_norm as gn

    x = _x((3, 64, 320))
    scale, bias = _affine(320)
    with switches(stats="pallas"), pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(jgn, "_pallas_channel_sums", wraps=jgn._pallas_channel_sums) as jk, \
            mock.patch.object(gn, "stream_channel_sums", wraps=gn.stream_channel_sums) as pk:
        wa, wb = jgn.group_affine(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5)
        ga, gb = gn.group_affine(t(x), t(scale), t(bias), 32, 1e-5)
    assert jk.call_count == 1 and pk.call_count == 1
    np.testing.assert_allclose(n(ga), n(wa), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(gb), n(wb), rtol=1e-5, atol=1e-6)


def test_stats_pallas_per_call_routes_through_the_kernel():
    """``FusedGroupNorm(stats="pallas")`` asks for kernel 6 with the switch
    off; the values are the composite ones up to summation order."""
    from animate_anything_tpu_torch.models.layers import FusedGroupNorm
    from animate_anything_tpu_torch.ops import group_norm as gn

    x = t(_x((2, 8, 8, 64)))
    scale, bias = _affine(64)
    plain, forced = FusedGroupNorm(64, 8, silu=True), FusedGroupNorm(64, 8, silu=True,
                                                                     stats="pallas")
    for m in (plain, forced):
        m.load_state_dict({"weight": t(scale), "bias": t(bias)})
    with mock.patch.object(gn, "stream_channel_sums", wraps=gn.stream_channel_sums) as pk, \
            torch.no_grad():
        want = plain(x)
        assert pk.call_count == 0
        got = forced(x)
    assert pk.call_count == 1
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


@pytest.mark.parametrize("silu", [True, False])
def test_streaming_group_norm_matches_the_pallas_kernel(silu):
    from animate_anything_tpu.ops.attic.streaming_group_norm import _pallas_group_norm
    from animate_anything_tpu.ops.group_norm import _pick_chunk
    from animate_anything_tpu_torch.ops.streaming_group_norm import group_norm_stream

    x = _x((3, 48, 128))
    scale, bias = _affine(128)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                  1e-5, silu, _pick_chunk(48, 128))
    with torch.no_grad():
        got = group_norm_stream(t(x), t(scale), t(bias), 32, 1e-5, silu)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)


@pytest.mark.parametrize("shape,kernel", [((2, 6, 8, 128), True), ((2, 6, 8, 320), False),
                                          ((2, 3, 128), False), ((2, 16, 256), True)])
def test_norm_switch_follows_the_jax_gate(shape, kernel):
    """Under ``set_default_norm_impl("pallas")`` both sides send the same
    GroupNorms to their one-pass kernel (counted on both sides): c a
    multiple of 128 with an aligned row chunk; c = 320, or 3 rows, keeps
    the composite form. The outputs agree either way."""
    from animate_anything_tpu.ops import group_norm as jgn
    from animate_anything_tpu.ops.attic import streaming_group_norm as jsg
    from animate_anything_tpu_torch.ops import group_norm as gn
    from animate_anything_tpu_torch.ops import streaming_group_norm as sg

    x = _x(shape)
    c = shape[-1]
    scale, bias = _affine(c)
    with switches(norm="pallas"), pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(jsg, "_pallas_group_norm", wraps=jsg._pallas_group_norm) as jk, \
            mock.patch.object(sg, "group_norm_stream", wraps=sg.group_norm_stream) as pk, \
            torch.no_grad():
        want = jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                   1e-5)
        got = gn.group_norm_silu(t(x), t(scale), t(bias), 32, 1e-5)
    assert jk.call_count == pk.call_count == int(kernel)
    assert got.shape == x.shape
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)


def test_streaming_group_norm_refuses_gradients():
    """JAX's streaming kernel has no VJP; the port's wrapper says so rather
    than hand back an output detached from its inputs."""
    from animate_anything_tpu_torch.ops.streaming_group_norm import group_norm_stream

    x = t(_x((2, 16, 128))).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        group_norm_stream(x, torch.ones(128), torch.zeros(128), 32)
    with torch.no_grad():
        assert group_norm_stream(x, torch.ones(128), torch.zeros(128), 32).grad_fn is None
