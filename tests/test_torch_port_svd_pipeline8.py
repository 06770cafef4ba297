"""The port's SVD pipeline against the JAX package's with the 8-channel UNet
(no motion mask) under ``attn_impl="xla"`` (JAX's default), the CLIP text
encoder and the hash tokenizer beside the image encoder: an image request,
``condition_type="text"`` (the prompt's hidden states as the context) and
``condition_type="both"`` (the image token and the prompt's, one context of
1 + 16 tokens). Inputs, JAX's draws and tolerances as
``test_torch_port_svd_pipeline.py``.
"""

import pytest

from test_torch_port_helpers import one_thread  # noqa: F401 (autouse fixture)
from test_torch_port_svd_pipeline import build_case, check, request_inputs, run_both


@pytest.fixture(scope="module")
def pipes():
    return build_case(8, "xla", text=True)


def test_image_without_mask_matches_jax(pipes):
    image, _, _ = request_inputs(3)
    check(*run_both(*pipes, 3, image=image, fps=5, motion_bucket_id=60,
                    noise_aug_strength=0.05, decode_chunk_size=2))


def test_text_condition_matches_jax(pipes):
    image, _, _ = request_inputs(2)
    check(*run_both(*pipes, 2, image=image, prompt="a dog runs on the beach",
                    condition_type="text"))


def test_both_conditions_match_jax(pipes):
    jpipe, ppipe = pipes
    image, _, _ = request_inputs(4)
    emb = ppipe.encode_image_embedding(image)
    text = ppipe.encode_text_embedding("clouds drift over a lake")
    assert tuple(emb.shape) == (1, 1, 32) and tuple(text.shape) == (1, 16, 32)
    check(*run_both(jpipe, ppipe, 4, image=image, prompt="clouds drift over a lake",
                    condition_type="both", min_guidance_scale=1.5))
