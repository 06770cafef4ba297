"""The plain reference against the port's CPU path at a small size: the
models in float32 on the same drawn weights, and one whole run of each cell
through the harness, judged correct with the committed limits. The test
imports both; the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest
import torch

from perfbench.harness import checks
from perfbench.tests.tiny import tiny_run, tiny_system


def test_reference_imports_nothing_of_the_program():
    for path in (Path(__file__).resolve().parents[1] / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("animate_anything_tpu_torch",
                                               "animate_anything_tpu", "jax", "flax"), path


@pytest.fixture(scope="module")
def a512():
    system, traffic, spec = tiny_system("a512.request")
    return system, traffic, spec


def test_a512_models_agree_in_float32(a512):
    system, traffic, _ = a512
    weights = system.draw(5)
    pipe = system.build_program(weights)
    for m in (pipe.unet, pipe.vae, pipe.text_encoder):
        m.float()
    ref = system.reference(weights)
    gen = torch.Generator().manual_seed(0)
    b, f, h = 2, 4, 8
    x = torch.randn(b, f, h, h, 4, generator=gen)
    cond = torch.randn(b, 1, h, h, 4, generator=gen)
    text = torch.randn(b, 77, 32, generator=gen)
    mask = (torch.rand(b, 1, h, h, 1, generator=gen) > 0.5).float()
    motion = torch.tensor([3.0, 7.0])
    with torch.no_grad():
        assert checks.rel_rms(pipe.unet(x, 500, text, cond, mask, motion),
                              ref.unet(x, 500, text, cond, mask, motion)) < 1e-5
        px = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
        assert checks.rel_rms(pipe.vae.encode(px), ref.vae.encode(px)) < 1e-5
        z = torch.randn(2, 8, 8, 4, generator=gen)
        assert checks.rel_rms(pipe.vae.decode(z, unscale=True), ref.vae.decode(z)) < 1e-5
        ids = torch.randint(0, 64, (2, 16), generator=gen)
        assert checks.rel_rms(pipe.text_encoder(ids), ref.text(ids)) < 1e-5


def test_a512_tokens_and_schedule_agree(a512):
    from animate_anything_tpu_torch.diffusion import dpmpp_timesteps, make_schedule
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer

    from perfbench.reference import dpm
    from perfbench.reference.clip_text import hash_token_ids

    texts = ["A girl moves her hands", ""]
    want = HashTokenizer(49408, 77)(texts, padding="max_length", max_length=77).input_ids
    assert hash_token_ids(texts, 49408, 77).tolist() == want.tolist()
    sched = a512[0].cfg["scheduler"]
    assert list(dpm.dpmpp_timesteps(sched, 25)) == list(dpmpp_timesteps(1000, 25))
    ac = make_schedule().alphas_cumprod.numpy()
    assert abs(dpm.alphas_cumprod(sched) - ac).max() < 1e-6


def test_a512_run_is_correct_on_the_cpu():
    result = tiny_run("a512.request", seed=2**31 + 77)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"request_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_svd_models_agree_in_float32():
    system, traffic, _ = tiny_system("svd.request")
    weights = system.draw(6)
    pipe = system.build_program(weights)
    for m in (pipe.unet, pipe.vae, pipe.image_encoder):
        m.float()
    ref = system.reference(weights)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 8, 8, 9, generator=gen)
    ctx = torch.randn(2, 1, 32, generator=gen)
    added = torch.tensor([[6.0, 127.0, 0.02]] * 2)
    with torch.no_grad():
        assert checks.rel_rms(pipe.unet(x, 0.7, ctx, added), ref.unet(x, 0.7, ctx, added)) < 1e-5
        px = torch.randn(1, 32, 32, 3, generator=gen)
        assert checks.rel_rms(pipe.image_encoder(px), ref.image(px)) < 1e-5


def test_svd_run_is_correct_on_the_cpu():
    result = tiny_run("svd.request", seed=2**31 + 78)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"request_s", "setup_s"}


def test_train_step_agrees_in_float32():
    """The port's finetune step with its modules back in float32 against the
    reference's on the same batch and draws: the loss and every leaf's
    gradient norm."""
    from perfbench.loops.train import leaf_norms

    system, traffic, _ = tiny_system("a512.train_b4")
    seed = 9
    trainer = system.build_trainer(system.draw(seed), seed)
    loss_fn = next(c.cell_contents for c in trainer["step"].__closure__
                   if getattr(c.cell_contents, "__name__", "") == "loss_fn")
    for cell in [*loss_fn.__closure__, *trainer["step"].__closure__]:
        if isinstance(cell.cell_contents, torch.nn.Module):
            cell.cell_contents.float()
    trainer["state"].model.float()
    batch = system.make_batch(traffic, seed, 0)
    got = system.train_step(trainer, batch)["loss"]
    grads = leaf_norms(system.first_gradients(trainer))
    ref = system.train_reference(system.draw(seed))
    want, ref_grads = ref.step(batch, torch.Generator().manual_seed(seed))
    ref_grads = leaf_norms(ref_grads)
    assert abs(got - want) < 1e-5 * abs(want)
    assert max(abs(grads[k] - ref_grads[k]) / ref_grads[k] for k in ref_grads
               if ref_grads[k] > 1e-8) < 1e-4


def test_train_run_on_the_cpu():
    """The whole training run at the small size: the losses and first
    gradients within the cell's limits. The change over three steps is
    held to 0.25 here, not to the cell's 0.04: at 8-channel widths a single
    small leaf's bf16 round-off moves its Adam update by several per cent
    (0.067 read), where the faults read 0.1 to 1 (``test_perfbench_control``);
    its direction, 1 − cos, to 0.3 (0.06 to 0.1 read; the faults that turn it
    read 1 to 2)."""
    result = tiny_run("a512.train_b4", seed=2**31 + 79)
    checks_ = result["checks"]
    for name in ("loss_rel", "grad_leaf_gap"):
        assert checks_[name]["value"] <= checks_[name]["limit"], checks_
    assert checks_["update_leaf_gap"]["value"] < 0.25, checks_
    assert checks_["update_leaf_cos"]["value"] < 0.3, checks_
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_step_s", "setup_s"}
