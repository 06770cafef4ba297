"""Prompt-to-prompt control (``utils/ptp.py``, ``utils/seq_align.py`` and
the controlled branch of ``ops/attention.attention``) against the JAX
package's, on the CPU in fp32:

- the sequence-alignment mappers and word indices (numpy on both sides)
  equal on the same prompts and tokenizer;
- an ``AttentionStore`` under one forward of the tiny mask+motion UNet
  (``attn_impl="xla"``; JAX's apply eager, as its capture needs): the same
  sites under the same down / mid / up / other keys (the port's module
  paths against JAX's flax paths), in the same order, each probability map
  within ``PROB_ATOL`` (fp32 softmax of the same scores; the UNet's inputs
  to the site agree within the 5e-5 of ``test_torch_port_unet.py``);
- an edit of the probabilities (the last context token's weight zeroed in
  every cross-attention): the edited UNet output within ``OUT_ATOL`` of
  JAX's and away from the unedited one;
- the alpha-word schedule equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

PROB_ATOL, OUT_ATOL = 1e-5, 5e-5
PROMPTS = ["a cat sits on a bench", "a fluffy cat sits on a wooden bench"]


def _tokenizer():
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    return HashTokenizer()


def test_seq_align_mappers_match_jax():
    from animate_anything_tpu.utils import seq_align as jax_sa
    from animate_anything_tpu_torch.utils import seq_align as sa

    tok = _tokenizer()
    for got, want in zip(sa.get_refinement_mapper(PROMPTS, tok, max_len=16),
                         jax_sa.get_refinement_mapper(PROMPTS, tok, max_len=16)):
        np.testing.assert_array_equal(got, want)
    swap = ["a cat on a bench", "a dog on a bench"]
    np.testing.assert_array_equal(sa.get_replacement_mapper(swap, tok, max_len=12),
                                  jax_sa.get_replacement_mapper(swap, tok, max_len=12))
    x, y = [1, 2, 3, 4, 5], [1, 3, 4, 9, 5]
    for g, w in zip(sa.global_align(x, y), jax_sa.global_align(x, y)):
        np.testing.assert_array_equal(g, w)
    for word in ("cat", "bench", 2):
        np.testing.assert_array_equal(sa.get_word_inds(PROMPTS[1], word, tok),
                                      jax_sa.get_word_inds(PROMPTS[1], word, tok))
    with pytest.raises(ValueError, match="word count"):
        sa.get_replacement_mapper_("a cat", "a big cat", tok)


def test_alpha_schedule_matches_jax():
    from animate_anything_tpu.utils import ptp as jax_ptp
    from animate_anything_tpu_torch.utils import ptp

    tok = _tokenizer()
    steps = {"default_": (0.0, 0.5), "fluffy": (0.1, 0.8)}
    got = ptp.get_time_words_attention_alpha(PROMPTS, 10, dict(steps), tok, 16)
    want = jax_ptp.get_time_words_attention_alpha(PROMPTS, 10, dict(steps), tok, 16)
    assert got.shape == (11, 1, 1, 1, 16)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def unet_case():
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    r = np.random.default_rng(1)
    b, f, hw = 1, 2, 8
    inputs = (r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), np.int32(500),
              r.standard_normal((b, 7, 32)).astype(np.float32),
              r.standard_normal((b, 1, hw, hw, 4)).astype(np.float32),
              (r.random((b, 1, hw, hw, 1)) > 0.5).astype(np.float32),
              np.array([3.0], np.float32))
    cfg = dict(motion_mask=True, motion_strength=True, attn_impl="xla")
    params = jax_params(JaxUNet(JaxCfg.tiny(**cfg)), *inputs, seed=2)
    port = load_into(UNet3DConditionModel(UNet3DConfig.tiny(**cfg)), unet3d_state_dict(params))
    return JaxUNet(JaxCfg.tiny(**cfg)), params, port, inputs


def _run(unet_case, jax_ctrl=None, port_ctrl=None):
    from animate_anything_tpu.utils import ptp as jax_ptp
    from animate_anything_tpu_torch.utils import ptp

    model, params, port, inputs = unet_case
    if jax_ctrl is None:
        want = model.apply(params, *inputs)
    else:
        with jax_ptp.attention_control(jax_ctrl):
            want = model.apply(params, *inputs)
    with torch.no_grad():
        args = [t(a) if a.ndim else int(a) for a in inputs]
        if port_ctrl is None:
            got = port(*args)
        else:
            with ptp.attention_control(port_ctrl):
                got = port(*args)
    return n(got), np.asarray(want)


def test_attention_store_matches_jax(unet_case):
    from animate_anything_tpu.utils import ptp as jax_ptp
    from animate_anything_tpu_torch.utils import ptp

    jstore, pstore = jax_ptp.AttentionStore(), ptp.AttentionStore()
    got, want = _run(unet_case, jstore, pstore)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    jstore.between_steps()
    pstore.between_steps()
    jmaps, pmaps = jstore.get_average_attention(), pstore.get_average_attention()
    assert set(jmaps) == set(pmaps)
    filled = {k for k, v in jmaps.items() if v}
    assert {"down_cross", "down_self", "up_cross", "up_self", "mid_cross",
            "mid_self"} <= filled
    for key in jmaps:
        assert len(pmaps[key]) == len(jmaps[key]), key
        for p_map, j_map in zip(pmaps[key], jmaps[key]):
            assert tuple(p_map.shape) == j_map.shape
            np.testing.assert_allclose(n(p_map), np.asarray(j_map), atol=PROB_ATOL)
    heat = ptp.aggregate_attention(pstore, 8, ["down", "up"], is_cross=True)
    want_heat = jax_ptp.aggregate_attention(jstore, 8, ["down", "up"], is_cross=True)
    assert tuple(heat.shape) == want_heat.shape == (8, 8, 7)
    np.testing.assert_allclose(n(heat), want_heat, atol=PROB_ATOL)


def test_attention_edit_matches_jax(unet_case):
    from animate_anything_tpu.utils import ptp as jax_ptp
    from animate_anything_tpu_torch.utils import ptp

    class JaxDropLast(jax_ptp.AttentionControl):
        def forward(self, attn, is_cross, place):
            return jnp.asarray(attn).at[..., -1].set(0.0) if is_cross else attn

    class DropLast(ptp.AttentionControl):
        def forward(self, attn, is_cross, place):
            if is_cross:
                attn = attn.clone()
                attn[..., -1] = 0.0
            return attn

    got, want = _run(unet_case, JaxDropLast(), DropLast())
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    plain, _ = _run(unet_case)
    assert np.abs(got - plain).max() > 100 * OUT_ATOL


def test_sites_tag_their_place_in_unet():
    """Each CrossAttention's path is its module name, so ``place_in_unet``
    reads down / mid / up from it; the SVD UNet's mid transformer reads
    "other", as JAX's ``mid_attentions_0`` does."""
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.models.attention import CrossAttention
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.utils.ptp import place_in_unet

    for model, mid in ((UNet3DConditionModel(UNet3DConfig.tiny()), "mid"),
                       (UNetSpatioTemporalConditionModel(SVDUNetConfig.tiny()), "other")):
        places = {}
        for name, m in model.named_modules():
            if isinstance(m, CrossAttention):
                assert m.path == tuple(name.split(".")) or m.path[0] == "mid_attentions"
                places.setdefault(name.split(".")[0], set()).add(place_in_unet(m.path))
        assert places == {"down_blocks": {"down"}, "mid_block": {mid}, "up_blocks": {"up"}}
