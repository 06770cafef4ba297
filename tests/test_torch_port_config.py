"""The port's config system and precision policy against the JAX package's:
``Config`` / ``merge_dotlist`` / ``load_config`` on every YAML in
``configs/`` with dotlist overrides (equal dicts, exactly), the scalar
parsing of overrides, ``Config``'s helpers, ``policy_from_string`` on every
name, and ``Config.save``'s YAML equal to JAX's for every config.
"""

import copy
import pathlib

import jax.numpy as jnp
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
OVERRIDES = ["validation_data.num_inference_steps=4", "learning_rate=5e-6",
             "mixed_precision=no", "new.nested.key=true", "attn_impl=xla",
             "validation_data.prompt=a cat walks", "eval_iters=2", "mesh.data=null",
             "trainable_modules=[attn1, attn2]"]


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
def test_load_config_matches_jax(path, overrides):
    from animate_anything_tpu.core.config import load_config as jax_load
    from animate_anything_tpu_torch.core.config import Config, load_config

    want = jax_load(str(path), overrides)
    got = load_config(str(path), overrides)
    assert isinstance(got, Config)
    assert got.to_dict() == want.to_dict()
    assert repr(got) == repr(want)


@pytest.mark.parametrize("raw", ["1", "-3", "1e-4", "5.0e-06", "true", "False", "null", "abc",
                                 "[1, 2]", "{a: 1}", "1e", "'7'", ""])
def test_parse_value_matches_jax(raw):
    from animate_anything_tpu.core.config import _parse_value as jax_parse
    from animate_anything_tpu_torch.core.config import _parse_value

    got, want = _parse_value(raw), jax_parse(raw)
    assert got == want and type(got) is type(want)


def test_config_helpers_match_jax(tmp_path):
    from animate_anything_tpu.core.config import Config as JaxConfig
    from animate_anything_tpu.core.config import merge_dotlist as jax_merge
    from animate_anything_tpu_torch.core.config import Config, load_config, merge_dotlist

    data = {"a": {"b": 1, "c": [{"d": 2}]}, "e": "x"}
    got, want = Config(data), JaxConfig(data)
    assert got.a.b == 1 and got.a.c[0].d == 2 and not hasattr(got, "missing")
    assert got.get_path("a.c") == want.get_path("a.c") and got.get_path("a.z", 5) == 5
    for cfg in (got, want):
        cfg.set_path("f.g.h", 3)
        cfg.merge({"a": {"b": 4, "k": 5}, "e": "y"})
    jax_merge(want, ["a.b=6", "z=1e-3"])
    merge_dotlist(got, ["a.b=6", "z=1e-3"])
    assert got.to_dict() == want.to_dict()
    deep = copy.deepcopy(got)
    deep.a.b = 0
    assert got.a.b == 6 and isinstance(deep, Config)
    with pytest.raises(ValueError):
        merge_dotlist(got, ["no_equals_sign"])
    got.save(str(tmp_path / "c.yaml"))
    assert load_config(str(tmp_path / "c.yaml")).to_dict() == want.to_dict()


@pytest.mark.parametrize("name", [None, "no", "fp32", "float32", "fp16", "bf16", "bfloat16",
                                  "float16"])
def test_policy_from_string_matches_jax(name):
    from animate_anything_tpu.core.dtypes import policy_from_string as jax_policy
    from animate_anything_tpu_torch.core.dtypes import policy_from_string

    want, got = jax_policy(name), policy_from_string(name)
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    assert want.param_dtype == jnp.float32
    assert got.compute_dtype == dtypes[want.compute_dtype]


def test_policy_from_string_refuses_unknown_names():
    from animate_anything_tpu.core.dtypes import policy_from_string as jax_policy
    from animate_anything_tpu_torch.core.dtypes import policy_from_string

    for fn in (jax_policy, policy_from_string):
        with pytest.raises(ValueError, match="mixed_precision"):
            fn("fp8")


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_config_save_writes_what_jax_writes(path, tmp_path):
    from animate_anything_tpu.core.config import load_config as jax_load
    from animate_anything_tpu_torch.core.config import load_config

    load_config(str(path), OVERRIDES).save(str(tmp_path / "port.yaml"))
    jax_load(str(path), OVERRIDES).save(str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    assert load_config(str(tmp_path / "port.yaml")).to_dict() == jax_load(
        str(path), OVERRIDES).to_dict()
