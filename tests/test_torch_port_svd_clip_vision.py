"""The port's CLIP vision tower (``models/clip_vision.py``) against the JAX
package's ``animate_anything_tpu/models/clip_vision.py``, on the CPU in fp32.

- ``CLIPVisionModelWithProjection`` (tiny config) under both GELU forms on
  the same normalised pixels, the weights carried over by
  ``utils/convert.py::clip_vision_state_dict`` with ``strict=True``; atol
  1e-5 (fp32 noise through two layers and two LayerNorms on outputs of
  magnitude ~1).
- ``preprocess_clip_image``: the same PIL resize and arithmetic, bit for bit.
- The key map: the port's state dict through JAX's ``convert_clip_vision``
  gives back JAX's tree exactly.
- ``init_clip_vision_`` draws the flax initialisers' laws.
"""

import math

import jax
import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_params, load_into, n, one_thread, t  # noqa: F401

ATOL = 1e-5


def _jax_case(act):
    from animate_anything_tpu.models.clip_vision import CLIPVisionConfig as JaxCfg
    from animate_anything_tpu.models.clip_vision import CLIPVisionModelWithProjection as JaxCLIP

    px = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = JaxCLIP(JaxCfg.tiny(hidden_act=act))
    return jm, jax_params(jm, px, seed=4), px


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_vision_matches_jax(act):
    from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                               CLIPVisionModelWithProjection)
    from animate_anything_tpu_torch.utils.convert import clip_vision_state_dict

    jm, p, px = _jax_case(act)
    port = load_into(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny(hidden_act=act)),
                     clip_vision_state_dict(p))
    with torch.no_grad():
        got = port(t(px))
    want = np.asarray(jax.jit(jm.apply)(p, px))
    assert got.shape == want.shape == (2, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, atol=ATOL)


def test_clip_vision_keys_round_trip_through_jax_import():
    from animate_anything_tpu.utils.import_torch import convert_clip_vision

    from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                               CLIPVisionModelWithProjection)
    from animate_anything_tpu_torch.utils.convert import clip_vision_state_dict

    _, p, _ = _jax_case("gelu")
    sd = clip_vision_state_dict(p)
    port_keys = set(CLIPVisionModelWithProjection(CLIPVisionConfig.tiny()).state_dict())
    assert set(sd) == port_keys
    assert {"vision_model.encoder.layers.1.self_attn.out_proj.weight",
            "vision_model.encoder.layers.0.mlp.fc2.bias", "vision_model.post_layernorm.weight",
            "vision_model.embeddings.class_embedding", "visual_projection.weight"} <= set(sd)
    back = convert_clip_vision({k: v.numpy() for k, v in sd.items()})
    flat = dict(jax.tree_util.tree_flatten_with_path(p["params"])[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, flat)) == set(map(str, flat_back))
    by_name = {str(k): v for k, v in flat_back.items()}
    for k, v in flat.items():
        np.testing.assert_array_equal(by_name[str(k)], np.asarray(v), err_msg=str(k))


@pytest.mark.parametrize("shape,size", [((48, 64, 3), 32), ((300, 200, 3), 224),
                                        ((7, 9, 3), 16)])
def test_preprocess_clip_image_is_jax_bit_for_bit(shape, size):
    from animate_anything_tpu.models.clip_vision import preprocess_clip_image as jax_pre

    from animate_anything_tpu_torch.models.clip_vision import preprocess_clip_image

    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    got, want = preprocess_clip_image(img, size), jax_pre(img, size)
    assert got.dtype == want.dtype == np.float32 and got.shape == (1, size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_init_clip_vision_matches_flax_initialisers():
    from animate_anything_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                                               CLIPVisionModelWithProjection)
    from animate_anything_tpu_torch.utils.convert import init_clip_vision_

    cfg = CLIPVisionConfig.tiny(hidden_size=256, image_size=256)
    m = init_clip_vision_(CLIPVisionModelWithProjection(cfg), torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in m.named_parameters()}
    emb = "vision_model.embeddings."
    assert abs(float(params[emb + "class_embedding"].std()) / 0.02 - 1.0) < 0.2
    pos = params[emb + "position_embedding.weight"]                    # N(0, 1/hidden)
    assert abs(float(pos.std()) * math.sqrt(256) - 1.0) < 0.05
    patch = params[emb + "patch_embedding.weight"]                      # lecun, fan-in 8·8·3
    assert abs(float(patch.std()) * math.sqrt(192) - 1.0) < 0.05
    assert float(patch.abs().max()) <= 2.0 / math.sqrt(192) / 0.8796 + 1e-6   # truncated at 2σ
    assert all(float(p.abs().max()) == 0 for k, p in params.items() if k.endswith(".bias"))
    assert bool((params["vision_model.post_layernorm.weight"] == 1).all())
