"""The port's fused resnet stage (kernel 8, ``ops/spatial_conv.py``) and the
opt-in ``ResnetBlock2D`` against the JAX package, on the CPU, in fp32.

JAX's ``gn_silu_spatial_conv`` and ``gn_silu_conv3x3`` (``ops/attic/``) send
every call to their XLA twins off the TPU (a platform check), so here the
twin they dispatch to is swapped for their Pallas ``_pallas_stage`` in
interpret mode, and the op itself is held against the port's (whose CPU
path is the plain version). Tolerance 2e-5 absolute, as the JAX package
holds its kernels against their twins; gradients go through JAX's custom
VJPs (``_fused_p``) and the port's ``Recompute``. The resnet is held at
5e-5 (two stages and a shortcut) with the same params on both sides.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_helpers import jax_params, load_into, n, t

ATOL, RESNET_ATOL, GRAD_ATOL = 2e-5, 5e-5, 1e-4


def _case(hw, cin, cout, seed=0, nb=2):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(nb, hw, hw, cin), scale=1.0 + 0.1 * f(cin), shift=0.1 * f(cin),
                w=f(3, 3, cin, cout) * 0.05, bias=0.1 * f(cout), extra=0.1 * f(nb, cout),
                res=f(nb, hw, hw, cout))


def _oihw(w):
    return t(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


@contextlib.contextmanager
def jax_kernel_stage(module, ch=8):
    """JAX's op with its Pallas kernel in interpret mode in place of the XLA
    twin it dispatches to off the TPU; yields the kernel's call counter."""
    if module.__name__.endswith("spatial_conv"):
        def stage(x, a, b, w9, bias_pb, residual, silu):
            return module._pallas_stage(x, a, b, w9, bias_pb, residual, ch=ch,
                                        co_ch=w9.shape[-1], silu=silu)
        name = "_reference_stage"
    else:
        stage, name = module._pallas_stage, "_reference_stage_exact"
    with pltpu.force_tpu_interpret_mode(), \
            mock.patch.object(module, name, side_effect=stage) as calls:
        yield calls


@pytest.mark.parametrize("hw,cin,cout,extra,residual", [
    (16, 64, 48, False, True), (16, 64, 64, True, False), (8, 128, 128, True, True)])
def test_gn_silu_spatial_conv_matches_the_pallas_stage(hw, cin, cout, extra, residual):
    from animate_anything_tpu.ops.attic import spatial_conv as jsc
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    c = _case(hw, cin, cout)
    kw = dict(groups=8, eps=1e-5)
    jkw = dict(extra_bias=jnp.asarray(c["extra"]) if extra else None,
               residual=jnp.asarray(c["res"]) if residual else None)
    with jax_kernel_stage(jsc) as calls:
        want = jsc.gn_silu_spatial_conv(jnp.asarray(c["x"]), jnp.asarray(c["scale"]),
                                        jnp.asarray(c["shift"]), jnp.asarray(c["w"]),
                                        jnp.asarray(c["bias"]), **kw, **jkw)
    assert calls.call_count == 1
    with mock.patch.object(sc, "spatial_conv", wraps=sc.spatial_conv) as port_calls, \
            torch.no_grad():
        got = sc.gn_silu_spatial_conv(t(c["x"]), t(c["scale"]), t(c["shift"]), _oihw(c["w"]),
                                      t(c["bias"]), **kw,
                                      extra_bias=t(c["extra"]) if extra else None,
                                      residual=t(c["res"]) if residual else None)
    assert port_calls.call_count == 1
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_gn_silu_conv3x3_matches_the_pallas_stage():
    """The v1 attic kernel's entry (no residual, always SiLU) through the
    same port kernel."""
    from animate_anything_tpu.ops.attic import conv3x3 as jc
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    c = _case(8, 32, 48, seed=1)
    with jax_kernel_stage(jc) as calls:
        want = jc.gn_silu_conv3x3(jnp.asarray(c["x"]), jnp.asarray(c["scale"]),
                                  jnp.asarray(c["shift"]), jnp.asarray(c["w"]),
                                  jnp.asarray(c["bias"]), groups=8,
                                  extra_bias=jnp.asarray(c["extra"]))
    assert calls.call_count == 1
    with torch.no_grad():
        got = sc.gn_silu_conv3x3(t(c["x"]), t(c["scale"]), t(c["shift"]), _oihw(c["w"]),
                                 t(c["bias"]), groups=8, extra_bias=t(c["extra"]))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def _folded(c, cout):
    """The stage's folded inputs, shared by both sides."""
    r = np.random.default_rng(7)
    nb, cin = c["x"].shape[0], c["x"].shape[-1]
    a = (1.0 + 0.1 * r.standard_normal((nb, cin))).astype(np.float32)
    b = (0.1 * r.standard_normal((nb, cin))).astype(np.float32)
    bias = (0.1 * r.standard_normal((nb, cout))).astype(np.float32)
    return a, b, bias


@pytest.mark.parametrize("residual", [True, False])
def test_spatial_conv_gradients_match_the_custom_vjp(residual):
    """Every input's gradient, JAX through ``_fused_p`` (its Pallas forward
    in interpret mode, its XLA twin's vjp) against the port's Recompute."""
    from animate_anything_tpu.ops.attic import spatial_conv as jsc
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    cout = 48
    c = _case(8, 32, cout, seed=2)
    a, b, bias = _folded(c, cout)
    res = c["res"] if residual else None
    g = np.random.default_rng(8).standard_normal(c["res"].shape).astype(np.float32)
    w9 = c["w"].reshape(9, 32, cout)
    jargs = [jnp.asarray(v) for v in (c["x"], a, b, w9, bias[:, None, :])]
    jres = None if res is None else jnp.asarray(res)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *ops: jsc._fused_p(*ops, 8, cout, True), *jargs, jres)
        want = vjp(jnp.asarray(g))
    targs = [t(v).requires_grad_(True) for v in (c["x"], a, b)]
    tw = _oihw(c["w"]).requires_grad_(True)
    tb = t(bias).requires_grad_(True)
    tr = None if res is None else t(res).requires_grad_(True)
    y = sc.spatial_conv(*targs, tw, tb, tr, True)
    y.backward(t(g))
    got = [v.grad for v in targs] + [tw.grad.permute(2, 3, 1, 0).reshape(9, 32, cout),
                                     tb.grad[:, None, :]]
    if tr is not None:
        got.append(tr.grad)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(n(gv), n(wv), atol=GRAD_ATOL, rtol=1e-4)


def test_gn_silu_spatial_conv_gradients_match_jax():
    """The op's gradients through the statistics fold, the time bias and the
    residual: ``jax.grad`` of JAX's op (its exact twin off the TPU) against
    the port's autograd."""
    from animate_anything_tpu.ops.attic import spatial_conv as jsc
    from animate_anything_tpu_torch.ops import spatial_conv as sc

    c = _case(8, 32, 32, seed=3)
    names = ("x", "scale", "shift", "w", "bias", "extra", "res")

    def jloss(x, s, sh, w, bias, extra, res):
        y = jsc.gn_silu_spatial_conv(x, s, sh, w, bias, groups=8, extra_bias=extra,
                                     residual=res)
        return jnp.sum(y * y)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*[jnp.asarray(c[k]) for k in names])
    tv = {k: t(c[k]).requires_grad_(True) for k in names}
    w_oihw = tv["w"].permute(3, 2, 0, 1)
    y = sc.gn_silu_spatial_conv(tv["x"], tv["scale"], tv["shift"], w_oihw, tv["bias"],
                                groups=8, extra_bias=tv["extra"], residual=tv["res"])
    (y * y).sum().backward()
    for k, wv in zip(names, want):
        np.testing.assert_allclose(n(tv[k].grad), n(wv), atol=GRAD_ATOL,
                                   rtol=1e-4, err_msg=k)


def test_opt_in_resnet_matches_jax(monkeypatch):
    """``AA_SPATIAL_CONV=1``: the port's ResnetBlock2D (cin ≠ cout, with a
    time embedding) runs both stages through the fused path, as JAX's
    ``ResnetBlock2D(impl="pallas")`` does (its kernel in interpret mode in
    place of its twin), on the same params: the state dict still loads
    strictly."""
    from animate_anything_tpu.models.layers import ResnetBlock2D as JaxResnet
    from animate_anything_tpu.ops.attic import spatial_conv as jsc
    from animate_anything_tpu_torch.models.layers import ResnetBlock2D
    from animate_anything_tpu_torch.ops import spatial_conv as sc
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    r = np.random.default_rng(4)
    x = r.standard_normal((4, 8, 8, 32)).astype(np.float32)
    temb = r.standard_normal((4, 64)).astype(np.float32)
    p = jax_params(JaxResnet(64, groups=8), x, temb)
    monkeypatch.setenv("AA_SPATIAL_CONV", "1")
    with jax_kernel_stage(jsc) as calls:
        want = JaxResnet(64, groups=8, impl="pallas").apply(p, x, temb)
    assert calls.call_count == 2
    port = load_into(ResnetBlock2D(32, 64, 64, groups=8), unet3d_state_dict(p["params"]))
    with mock.patch.object(sc, "spatial_conv", wraps=sc.spatial_conv) as port_calls, \
            torch.no_grad():
        got = port(t(x), t(temb))
    assert port_calls.call_count == 2
    np.testing.assert_allclose(n(got), n(want), atol=RESNET_ATOL)
    monkeypatch.setenv("AA_SPATIAL_CONV", "0")
    with mock.patch.object(sc, "spatial_conv", wraps=sc.spatial_conv) as port_calls, \
            torch.no_grad():
        composite = port(t(x), t(temb))
    assert port_calls.call_count == 0
    np.testing.assert_allclose(n(composite), n(want), atol=RESNET_ATOL)


def test_spatial_conv_optin_reads_the_environment_at_call_time(monkeypatch):
    from animate_anything_tpu_torch.ops import group_norm as gn
    from animate_anything_tpu_torch.ops.spatial_conv import SPATIAL_CONV_OPTIN, opt_in_config

    monkeypatch.delenv("AA_SPATIAL_CONV", raising=False)
    assert not SPATIAL_CONV_OPTIN()
    with opt_in_config():
        assert SPATIAL_CONV_OPTIN()
        assert gn._DEFAULT_IMPL == gn._DEFAULT_STATS == "pallas"
    assert not SPATIAL_CONV_OPTIN()
    assert gn._DEFAULT_IMPL == gn._DEFAULT_STATS == "xla"
    monkeypatch.setenv("AA_SPATIAL_CONV", "1")
    assert SPATIAL_CONV_OPTIN()
