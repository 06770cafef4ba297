"""Textual-inversion tokens (``models/textual_inversion.py``) against the JAX
package's, on the CPU in fp32: embedding files the test writes (a
safetensors file of two placeholders, one of two vectors; an AUTOMATIC1111
``.pt`` file) load to the same arrays, the tiny CLIP text model grows by the
same rows under diffusers' ``token_embedding`` key, the wrapped tokenizers
splice the same ids, and the grown encoders' outputs agree within 1e-5
(fp32 noise of ``test_torch_port_clip.py``'s encoder parity).
"""

import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_params, load_into, n, one_thread  # noqa: F401

ATOL = 1e-5
PROMPTS = ["a <cat-toy> sits on a bench", "a photo of <style> <cat-toy>"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("ti")
    r = np.random.default_rng(4)
    st = str(d / "learned.safetensors")
    save_file({"<cat-toy>": r.standard_normal((1, 32)).astype(np.float32),
               "<style>": r.standard_normal((2, 32)).astype(np.float32)}, st)
    pt = str(d / "a1111.pt")
    torch.save({"name": "<a1111>", "string_to_param": {"*": torch.randn(3, 32)}}, pt)
    return st, pt


def test_embedding_files_load_as_jax_loads_them(files):
    from animate_anything_tpu.models import textual_inversion as jax_ti
    from animate_anything_tpu_torch.models import textual_inversion as ti

    for path in files:
        got, want = ti.load_embedding_file(path), jax_ti.load_embedding_file(path)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])


def test_injected_embeddings_encode_as_jax(files):
    import dataclasses

    import jax.numpy as jnp

    from animate_anything_tpu.models import textual_inversion as jax_ti
    from animate_anything_tpu.models.clip_text import CLIPTextConfig as JaxCfg
    from animate_anything_tpu.models.clip_text import CLIPTextModel as JaxCLIP
    from animate_anything_tpu.models.factory import HashTokenizer as JaxTokenizer
    from animate_anything_tpu_torch.models import textual_inversion as ti
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.utils.convert import clip_text_state_dict

    jcfg = JaxCfg.tiny(hidden_size=32)
    params = jax_params(JaxCLIP(jcfg), np.zeros((1, 16), np.int32), seed=5)
    model = load_into(CLIPTextModel(CLIPTextConfig.tiny(hidden_size=32)),
                      clip_text_state_dict(params))
    emb = ti.load_embedding_file(files[0])

    jparams, jtok, jadded = jax_ti.inject_embeddings(
        params, JaxTokenizer(jcfg.vocab_size, jcfg.max_position_embeddings), emb)
    model, tok, added = ti.inject_embeddings(
        model, HashTokenizer(jcfg.vocab_size, jcfg.max_position_embeddings), emb)
    assert added == jadded == 3
    assert model.config.vocab_size == jcfg.vocab_size + 3
    table = model.state_dict()["text_model.embeddings.token_embedding.weight"]
    np.testing.assert_array_equal(n(table), np.asarray(
        jparams["params"]["token_embedding"]["embedding"]))
    assert tok.placeholder_ids == jtok.placeholder_ids == {"<cat-toy>": [64], "<style>": [65, 66]}

    ids = tok(PROMPTS, padding="max_length", max_length=16).input_ids
    want_ids = jtok(PROMPTS, padding="max_length", max_length=16).input_ids
    np.testing.assert_array_equal(ids, want_ids)
    assert (ids >= jcfg.vocab_size).sum() == 4
    with torch.no_grad():
        got = model(torch.as_tensor(ids))
    want = JaxCLIP(dataclasses.replace(jcfg, vocab_size=jcfg.vocab_size + 3)).apply(
        jparams, jnp.asarray(want_ids))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        plain = model(torch.as_tensor(tok(["a sits on a bench", "a photo of"],
                                          padding="max_length", max_length=16).input_ids))
    assert float((got - plain).abs().max()) > 1e-3


def test_injection_refuses_another_width(files):
    from animate_anything_tpu_torch.models import textual_inversion as ti
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    model = CLIPTextModel(CLIPTextConfig.tiny(hidden_size=16))
    with pytest.raises(ValueError, match="embedding dim 32"):
        ti.inject_embeddings(model, HashTokenizer(64, 16), ti.load_embedding_file(files[0]))
