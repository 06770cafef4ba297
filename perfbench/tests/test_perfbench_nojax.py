"""The no-JAX rule compares whole top-level module names."""

import sys
import types

import pytest

from perfbench.harness import env


@pytest.mark.parametrize("name, bad", [("animate_anything_tpu_torch.ops.geglu", False),
                                       ("animate_anything_tpu_torch", False),
                                       ("animate_anything_tpu", True),
                                       ("animate_anything_tpu.models.unet3d", True),
                                       ("jax", True), ("jaxlib.xla_client", True),
                                       ("flax.linen", True), ("jaxtyping", False)])
def test_whole_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in env.forbidden_modules()) == bad


def test_the_harness_and_reference_load_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.run, perfbench.loops, perfbench.reference.latent2video;"
            "from perfbench.harness import env, registry;"
            "[registry.config_module(c['name']) for c in registry.benchmark()['configs']];"
            "[registry.loop_module(registry.workload(w['name'])['loop'])"
            " for w in registry.benchmark()['workloads']];"
            "print(env.forbidden_modules())")
    from perfbench.harness.registry import REPO

    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
