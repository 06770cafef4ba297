"""The port's blockwise 8-bit AdamW (``ops/adam8bit.py``) against the JAX
package's ``adamw_8bit``, on the CPU.

- the quantizers against ``_quant_sym`` / ``_quant_pos`` (ragged sizes, an
  all-zero block): the codes equal, the scales within 1e-7 relative;
- several steps of ``chain(clip_by_global_norm, adamw_8bit)`` on seeded
  arrays with clipping active: after each step the int8 / uint8 moments
  (equal but for at most one code in a thousand by one step, where the
  fp32 Adam math lands within an ulp of a rounding boundary on one side),
  their per-block scales (1e-6 relative) and the parameters (1e-6
  absolute);
- ``make_optimizer(use_8bit_adam=True)`` with freezing and ``MultiSteps``
  (k = 2) against JAX's ``make_optimizer``: the parameters (1e-6), frozen
  ones untouched;
- the state at ~2.03 bytes a parameter against AdamW's 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import n, t

SHAPES = {"w": (37, 19), "conv": (3, 3, 8, 16), "b": (300,), "tiny": (5,)}


def _params(seed=0):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("size", [1, 255, 256, 700])
def test_quantizers_match_jax(size):
    from animate_anything_tpu.ops.adam8bit import _quant_pos, _quant_sym
    from animate_anything_tpu_torch.ops.adam8bit import blocked, nblocks, quantize

    r = np.random.default_rng(size)
    x = (r.standard_normal(size) * 1e-3).astype(np.float32)
    if size > 256:
        x[:256] = 0.0         # an all-zero block
    for signed, fn, v in ((True, _quant_sym, x), (False, _quant_pos, np.abs(x))):
        want = fn(jnp.asarray(v), 256)
        q, scale = quantize(blocked(t(v)), signed)
        assert q.dtype == (torch.int8 if signed else torch.uint8)
        assert scale.shape == (nblocks(size),)
        np.testing.assert_array_equal(q.reshape(-1)[:size].numpy(), np.asarray(want.q))
        np.testing.assert_allclose(n(scale), np.asarray(want.scale), rtol=1e-7)


def _jax_moments(state):
    """(m codes, m scales, v codes, v scales) by leaf from JAX's state."""
    _, adam = state
    return ({k: np.asarray(z.q) for k, z in adam.m.items()},
            {k: np.asarray(z.scale) for k, z in adam.m.items()},
            {k: np.asarray(z.q) for k, z in adam.v.items()},
            {k: np.asarray(z.scale) for k, z in adam.v.items()})


def test_steps_match_jax_with_clipping():
    import optax

    from animate_anything_tpu.ops.adam8bit import adamw_8bit
    from animate_anything_tpu_torch.ops.adam8bit import AdamW8bit
    from animate_anything_tpu_torch.train import TrainConfig

    params = _params()
    kw = dict(learning_rate=1e-2, adam_weight_decay=0.05, max_grad_norm=0.5)
    tx = optax.chain(optax.clip_by_global_norm(kw["max_grad_norm"]),
                     adamw_8bit(kw["learning_rate"], weight_decay=kw["adam_weight_decay"]))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    masters = {k: t(v).clone() for k, v in params.items()}
    opt = AdamW8bit(TrainConfig(**kw), masters)
    r = np.random.default_rng(1)
    for step in range(5):
        grads = {k: (r.standard_normal(s) * (0.3 + step)).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, state = jax.jit(tx.update)(jax.tree_util.tree_map(jnp.asarray, grads), state,
                                            jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert opt.step({k: t(v) for k, v in grads.items()}, masters)
        mq, ms, vq, vs = _jax_moments(state)
        for k in SHAPES:
            np.testing.assert_allclose(n(masters[k]), np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"{k} @ {step}")
            for got, want, what in ((opt.m_q[k], mq[k], "m"), (opt.v_q[k], vq[k], "v")):
                diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).sum() <= max(1, diff.size // 1000), \
                    f"{what} codes of {k} @ {step}: {(diff > 0).sum()} differ"
            np.testing.assert_allclose(n(opt.m_scale[k]), ms[k], rtol=1e-6)
            np.testing.assert_allclose(n(opt.v_scale[k]), vs[k], rtol=1e-6)
    assert opt.count == 5


def test_make_optimizer_routes_8bit_with_freezing_and_accumulation():
    """JAX's ``make_optimizer`` (multi_transform freeze + ``MultiSteps`` k = 2
    around the 8-bit AdamW) against the port's on a two-leaf toy: only
    'train'-labelled leaves move, every second micro-step."""
    from animate_anything_tpu.train.trainer import TrainConfig as JaxConfig
    from animate_anything_tpu.train.trainer import make_optimizer as jax_optimizer
    from animate_anything_tpu_torch.ops.adam8bit import AdamW8bit
    from animate_anything_tpu_torch.train import TrainConfig, make_optimizer

    params = {"keep": {"kernel": _params()["w"]}, "frozen": {"kernel": _params(1)["w"]}}
    kw = dict(learning_rate=1e-2, use_8bit_adam=True, trainable_modules=("keep",),
              gradient_accumulation_steps=2, max_grad_norm=1.0)
    tx = jax_optimizer(JaxConfig(**kw), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    masters = {"keep.kernel": t(params["keep"]["kernel"]).clone()}
    opt = make_optimizer(TrainConfig(**kw), masters)
    assert isinstance(opt, AdamW8bit)
    r = np.random.default_rng(2)
    for micro in range(6):
        g = {"keep": {"kernel": r.standard_normal(SHAPES["w"]).astype(np.float32)},
             "frozen": {"kernel": r.standard_normal(SHAPES["w"]).astype(np.float32)}}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        changed = opt.step({"keep.kernel": t(g["keep"]["kernel"])}, masters)
        assert changed == (micro % 2 == 1)
        np.testing.assert_allclose(n(masters["keep.kernel"]), np.asarray(jparams["keep"]["kernel"]),
                                   atol=1e-6, err_msg=f"@ {micro}")
        np.testing.assert_array_equal(np.asarray(jparams["frozen"]["kernel"]),
                                      params["frozen"]["kernel"])


def test_state_bytes_are_about_two_a_parameter():
    from animate_anything_tpu_torch.train import AdamW, TrainConfig
    from animate_anything_tpu_torch.ops.adam8bit import AdamW8bit

    masters = {"a": torch.zeros(1024, 1024), "b": torch.zeros(4096)}
    count = sum(v.numel() for v in masters.values())
    small = AdamW8bit(TrainConfig(use_8bit_adam=True), masters).state_bytes() / count
    assert 2.0 < small < 2.04
    assert AdamW(TrainConfig(), masters).state_bytes() / count == 8.0


def test_state_dict_round_trip():
    from animate_anything_tpu_torch.ops.adam8bit import AdamW8bit
    from animate_anything_tpu_torch.train import TrainConfig

    cfg = TrainConfig(use_8bit_adam=True, learning_rate=1e-2)
    masters = {k: t(v).clone() for k, v in _params().items()}
    opt = AdamW8bit(cfg, masters)
    g = {k: torch.ones_like(v) for k, v in masters.items()}
    opt.step(g, masters)
    other = AdamW8bit(cfg, {k: v.clone() for k, v in masters.items()})
    other.load_state_dict(opt.state_dict())
    assert other.count == 1
    for key in AdamW8bit.STATE:
        for k in masters:
            assert torch.equal(getattr(other, key)[k], getattr(opt, key)[k])
