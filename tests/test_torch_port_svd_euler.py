"""The port's Euler/EDM math (``diffusion/euler_edm.py``) against the JAX
package's ``animate_anything_tpu/diffusion/euler_edm.py``, on the CPU.

Inputs are drawn with numpy from a seed. The schedule is built in float64
on both sides and stored in fp32, so its σ and timesteps must be equal bit
for bit. The step functions are fp32 arithmetic of the same formulas in the
same order: they are held to 1e-6 relative (XLA may fuse a multiply-add
where torch rounds twice), and a bf16 sample must come back in bf16 within
1e-2 (about two bf16 ulps: the fp32 intermediate rounds once more on
each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import n, one_thread, t  # noqa: F401 (autouse fixture)

RTOL = 1e-6


@pytest.mark.parametrize("steps", [1, 2, 25, 50])
def test_euler_schedule_is_jax_bit_for_bit(steps):
    from animate_anything_tpu.diffusion import euler_edm as jx

    from animate_anything_tpu_torch.diffusion import euler_edm as pt

    want, got = jx.make_euler_schedule(steps), pt.make_euler_schedule(steps)
    assert got.sigmas.dtype == got.timesteps.dtype == torch.float32
    assert got.sigmas.shape == (steps + 1,) and got.timesteps.shape == (steps,)
    np.testing.assert_array_equal(n(got.sigmas), np.asarray(want.sigmas))
    np.testing.assert_array_equal(n(got.timesteps), np.asarray(want.timesteps))
    np.testing.assert_allclose(float(got.init_noise_sigma), float(want.init_noise_sigma),
                               rtol=RTOL)
    assert float(got.sigmas[-1]) == 0.0
    # 0.25·log σ: continuous, never an integer grid
    assert not np.allclose(n(got.timesteps), np.round(n(got.timesteps)))
    np.testing.assert_array_equal(pt.karras_sigmas(steps, 0.002, 700.0),
                                  jx.karras_sigmas(steps, 0.002, 700.0))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_scale_model_input_and_euler_step_match_jax(dtype):
    from animate_anything_tpu.diffusion import euler_edm as jx

    from animate_anything_tpu_torch.diffusion import euler_edm as pt

    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 3, 4, 4, 4)) * 20).astype(np.float32)
    out = r.standard_normal(x.shape).astype(np.float32)
    es = pt.make_euler_schedule(25)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, oj = jnp.asarray(x, jdt), jnp.asarray(out, jdt)
    xt, ot = t(x).to(tdt), t(out).to(tdt)
    for i in (0, 7, 24):
        sigma, nxt = es.sigmas[i], es.sigmas[i + 1]
        sj, nj = jnp.float32(float(sigma)), jnp.float32(float(nxt))
        got = pt.scale_model_input(xt, sigma)
        want = jx.scale_model_input(xj, sj)
        assert got.dtype == tdt
        np.testing.assert_allclose(n(got), np.asarray(want, np.float32), rtol=1e-2 if
                                   dtype == "bfloat16" else RTOL, atol=1e-30)
        got = pt.euler_step(xt, ot, sigma, nxt)
        want = jx.euler_step(xj, oj, sj, nj)
        assert got.dtype == tdt
        tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else dict(rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


def test_edm_precondition_matches_jax():
    from animate_anything_tpu.diffusion import euler_edm as jx

    from animate_anything_tpu_torch.diffusion import euler_edm as pt

    sig = np.exp(np.random.default_rng(1).standard_normal((5, 1, 1, 1, 1)) * 1.6 + 0.7)
    sig = sig.astype(np.float32)
    want, got = jx.edm_precondition(jnp.asarray(sig)), pt.edm_precondition(t(sig))
    for name in ("sigma", "c_skip", "c_out", "c_in", "c_noise", "loss_weight"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(n(g), w, rtol=RTOL, err_msg=name)


def test_edm_sample_sigmas_is_the_lognormal_of_its_generator():
    from animate_anything_tpu_torch.diffusion import euler_edm as pt

    gen = torch.Generator().manual_seed(3)
    got = pt.edm_sample_sigmas(4096, gen)
    assert got.shape == (4096, 1, 1, 1, 1) and got.dtype == torch.float32
    z = torch.randn((4096, 1, 1, 1, 1), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, torch.exp(z * 1.6 + 0.7))
    logs = torch.log(got).flatten()
    assert abs(float(logs.mean()) - 0.7) < 0.1 and abs(float(logs.std()) - 1.6) < 0.1
