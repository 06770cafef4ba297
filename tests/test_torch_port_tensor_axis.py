"""The tensor axis of the port on the CPU (gloo): ``parallel/tensor.py``,
``partition.param_partition_spec``, kernels 2 and 5's partial modes and the
tensor-split forward, steps and checkpoints.

- no spawn: ``param_partition_spec`` against JAX's on the nano and the
  full-width parameter trees, case by case, at tensor 2 and 4; the sites
  the port splits at tensor 2 and 4 (whole heads; at full width and for the
  nano config); the GEGLU val/gate pairing and its inverse; kernels 2 and
  5's plain partial modes, summed over two slices, against the whole call;
- then 2 spawned gloo ranks on a ``{data: 1, tensor: 2}`` mesh (one spawn
  for the module, one thread a rank), against the single process on the
  same inputs: the tiny UNet's forward under ``"pallas"`` and ``"xla"`` at a
  width whose heads the axis divides (``UNet3DConfig.tiny``: 4 and 8 heads)
  and at one whose heads it does not (3 heads at 96 channels, run
  replicated, beside 6 that split); the full-finetune step (loss, grad
  norm, every gradient: a split one is the rank's slice of the
  one-process gradient, a replicated one the same on both ranks; the
  masters after the update); two 8-bit AdamW micro-steps under gradient
  accumulation; a checkpoint written at tensor 2 that loads at one process
  and gives the same forward, and a one-process checkpoint resumed at
  tensor 2; ``cli_svd.main`` at ``mesh.tensor=2``.

Tolerances (fp32 on both sides, ``mixed_precision: fp32``; the sides differ
in the order of fp32 sums: each row-parallel product summed over the two
ranks): forwards 1e-5 of their largest magnitude; loss and grad norm 1e-5
relative; gradients 1e-5 of each array's largest magnitude plus 1e-7 of
the largest gradient anywhere (a bias that feeds a GroupNorm has a gradient
of exactly zero, which both sides give as fp32 sum-order noise);
masters 1e-6 absolute (1 % of an AdamW update at lr 1e-4, as the data
axis's test); 8-bit masters 5e-5 (that test's).
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_port_data_parallel import GROUP_TIMEOUT, TIMEOUT, _close, one_thread

REL = 1e-5
GRAD_ATOL = 1e-7     # of the largest gradient anywhere
MASTER_ATOL = 1e-6
B = 2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# -- the rules and plans (no spawn) ------------------------------------------

def _jax_specs(cfg_kw: dict, tensor: int) -> dict:
    """JAX's ``param_partition_spec`` over its UNet's parameter tree (shapes
    only, ``jax.eval_shape``) → flax path → the flax dim it splits (None
    replicated)."""
    import jax
    import jax.numpy as jnp

    from animate_anything_tpu.core.mesh import AXIS_TENSOR
    from animate_anything_tpu.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu.parallel import partition

    cfg = UNet3DConfig(**cfg_kw)
    unet = UNet3DConditionModel(cfg)
    b, f, hw = 1, 2, 4
    shapes = jax.eval_shape(
        unet.init, jax.random.PRNGKey(0), jnp.zeros((b, f, hw, hw, 4)), jnp.array(1),
        jnp.zeros((b, 7, cfg.cross_attention_dim)), jnp.zeros((b, 1, hw, hw, 4)),
        jnp.ones((b, 1, hw, hw, 1)), jnp.ones((b,)))
    mesh = types.SimpleNamespace(axis_names=("data", "tensor"),
                                 devices=np.empty((1, tensor)))
    out = {}

    def visit(path, v):
        spec = tuple(partition.param_partition_spec(path, v, mesh))
        out["params." + partition._path_str(path[1:])] = (
            spec.index(AXIS_TENSOR) if AXIS_TENSOR in spec else None)

    jax.tree_util.tree_map_with_path(visit, shapes)
    return out


def _port_unet(cfg_kw: dict, meta: bool = True):
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    if meta:
        with torch.device("meta"):
            return UNet3DConditionModel(UNet3DConfig(**cfg_kw))
    return UNet3DConditionModel(UNet3DConfig(**cfg_kw))


NANO = dict(block_out_channels=(32, 64), down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
            up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"), layers_per_block=1,
            cross_attention_dim=32, attention_head_dim=8, norm_num_groups=8, motion_mask=True,
            motion_strength=True)
FULL = dict(motion_mask=True, motion_strength=True)


@pytest.mark.parametrize("tensor", [2, 4])
@pytest.mark.parametrize("which", ["nano", "full"])
def test_param_partition_spec_is_jax_rule_case_by_case(which, tensor):
    """Every parameter: the torch dim the port's rule splits is JAX's flax
    dim mirrored (a Dense kernel (in, out) against a Linear weight (out,
    in)), None where JAX replicates."""
    from animate_anything_tpu_torch.parallel.partition import param_partition_spec
    from animate_anything_tpu_torch.utils.convert import flax_path

    cfg = NANO if which == "nano" else FULL
    want = _jax_specs(cfg, tensor)
    split = 0
    for name, p in _port_unet(cfg).named_parameters():
        path = flax_path(name, p.ndim)
        assert path in want, (name, path)
        got = param_partition_spec(name, tuple(p.shape), tensor)
        jdim = want[path]
        assert got == (None if jdim is None else 1 - jdim), (name, got, jdim)
        split += got is not None
    assert split > 0
    assert param_partition_spec("x.to_q.weight", (64, 32), 1) is None


def _sites(cfg_kw: dict, tensor: int) -> dict:
    """(kind, width, heads) → [sites that split, sites that do not]."""
    from animate_anything_tpu_torch.models.attention import GEGLUFeedForward, HeadsSite
    from animate_anything_tpu_torch.parallel.tensor import site_splits

    out = {}
    for _, m in _port_unet(cfg_kw).named_modules():
        if isinstance(m, HeadsSite):
            key = ("attn", m.heads * m.head_dim, m.heads)
        elif isinstance(m, GEGLUFeedForward):
            key = ("ff", m.net[2].out_features, None)
        else:
            continue
        out.setdefault(key, [0, 0])[0 if site_splits(m, tensor) else 1] += 1
    return out


def test_sites_that_split_at_tensor_two_and_four():
    """Whole heads: at full width the 5-head 320 sites never split, the
    10-head 640 sites at tensor 2 only, the 20-head 1280 sites and
    transformer_in's 8 heads (512 on 320 channels) at 2 and 4; every
    feed-forward splits its hidden columns. The nano config's 4- and 8-head
    sites split at both."""
    attn_full = {320: 5, 640: 10, 1280: 20, 512: 8}
    for tensor in (2, 4):
        full = _sites(FULL, tensor)
        for (kind, width, heads), (yes, no) in full.items():
            if kind == "ff":
                assert no == 0 and yes > 0, (width, tensor)
                continue
            assert attn_full[width] == heads
            assert (no == 0) == (heads % tensor == 0) and (yes == 0) == (heads % tensor != 0)
        assert {w for (k, w, _), (yes, _) in full.items() if k == "attn" and yes} == (
            {640, 1280, 512} if tensor == 2 else {1280, 512})
        nano = _sites(NANO, tensor)
        assert all(no == 0 for (yes, no) in nano.values()), nano
    # the counts at full width, tensor 2: (split, replicated)
    full2 = _sites(FULL, 2)
    assert full2[("attn", 320, 5)] == [0, 20] and full2[("attn", 640, 10)] == [20, 0]
    assert full2[("attn", 1280, 20)] == [24, 0] and full2[("attn", 512, 8)] == [2, 0]
    assert _sites(FULL, 4)[("attn", 640, 10)] == [0, 20]


def test_geglu_pairing_and_its_inverse():
    """Rank r's net.0.proj rows: the val rows and the gate rows of hidden
    columns [r·4c/T, (r+1)·4c/T); joining the slices undoes the pairing."""
    from animate_anything_tpu_torch.parallel.tensor import TPGroup, join_slices, local_slice

    c, tensor = 8, 2
    w = torch.arange(8 * c * c, dtype=torch.float32).reshape(8 * c, c)
    parts = [local_slice(w, 0, True, TPGroup(tensor, r)) for r in range(tensor)]
    q = 4 * c // tensor
    for r, p in enumerate(parts):
        assert torch.equal(p[:q], w[r * q:(r + 1) * q])                  # values
        assert torch.equal(p[q:], w[4 * c + r * q:4 * c + (r + 1) * q])  # their gates
    assert torch.equal(join_slices(parts, 0, True), w)
    cols = [local_slice(w.t(), 1, False, TPGroup(tensor, r)) for r in range(tensor)]
    assert torch.equal(join_slices(cols, 1, False), w.t())


def test_partial_modes_sum_to_the_whole_call():
    """Kernels 2 and 5's plain versions in their partial mode on each
    rank's slice, summed, plus the bias and the residual, equal the whole
    call (fp32, 1e-5 of the largest magnitude)."""
    from animate_anything_tpu_torch.ops.geglu import ln_geglu_ff
    from animate_anything_tpu_torch.ops.temporal_block import temporal_block
    from animate_anything_tpu_torch.parallel.tensor import TPGroup, local_slice

    g = _gen(1)
    c, heads = 32, 4
    x = torch.randn((2, 5, 6, c), generator=g)
    ln_s, ln_b = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    w1, b1 = 0.2 * torch.randn((8 * c, c), generator=g), 0.1 * torch.randn(8 * c, generator=g)
    w2, b2 = 0.2 * torch.randn((c, 4 * c), generator=g), 0.1 * torch.randn(c, generator=g)
    whole = ln_geglu_ff(x, ln_s, ln_b, w1, b1, w2, b2)
    parts = [ln_geglu_ff(x, ln_s, ln_b, local_slice(w1, 0, True, TPGroup(2, r)),
                         local_slice(b1, 0, True, TPGroup(2, r)),
                         local_slice(w2, 1, False, TPGroup(2, r)), None, partial=True)
             for r in range(2)]
    _close(sum(parts) + b2 + x, whole, "kernel 2", rel=REL)
    wq, wk, wv, wo = (0.2 * torch.randn((c, c), generator=g) for _ in range(4))
    bo = 0.1 * torch.randn(c, generator=g)
    whole = temporal_block(x, ln_s, ln_b, wq, wk, wv, wo, bo, heads=heads)
    parts = []
    for r in range(2):
        tp = TPGroup(2, r)
        parts.append(temporal_block(x, ln_s, ln_b, *(local_slice(w, 0, False, tp)
                                                      for w in (wq, wk, wv)),
                                    local_slice(wo, 1, False, tp), None, heads=heads // 2,
                                    partial=True))
    _close(sum(parts) + bo + x, whole, "kernel 5", rel=REL)


# -- the spawned ranks -------------------------------------------------------

ODD = dict(block_out_channels=(96, 192, 192, 192), attention_head_dim=32)


def _tiny(kind: str, impl: str, seed: int = 0):
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    kw = dict(motion_mask=True, motion_strength=True, attn_impl=impl)
    if kind == "odd":
        kw.update(ODD)
    unet = init_unet3d_(UNet3DConditionModel(UNet3DConfig.tiny(**kw)), _gen(seed))
    # conv4 of each temporal conv starts at zero: give it weights, so the
    # temporal convs reach the output and their gradients are not all zero
    for name, p in unet.named_parameters():
        if "conv4" in name:
            p.data = 0.05 * torch.randn(p.shape, generator=_gen(p.numel()))
    return unet


def _inputs():
    g = _gen(7)
    mask = torch.zeros((B, 1, 8, 8, 1))
    mask[:, :, 2:6] = 1.0
    return (torch.randn((B, 3, 8, 8, 4), generator=g), torch.tensor(400),
            torch.randn((B, 7, 32), generator=g), torch.randn((B, 1, 8, 8, 4), generator=g),
            mask, torch.tensor([3.0, 5.0]))


def _forwards(mesh) -> dict:
    from animate_anything_tpu_torch.parallel.tensor import shard_model

    out = {}
    with torch.no_grad():
        for kind in ("tiny", "odd"):
            for impl in ("pallas", "xla"):
                unet = _tiny(kind, impl).eval()
                plan = shard_model(unet, mesh)
                out[f"{kind}.{impl}"] = unet(*_inputs())
                out[f"{kind}.{impl}.split"] = sorted(plan)
    return out


def _batch(step: int) -> dict:
    g = _gen(10 + step)
    mask = torch.zeros((B, 64, 64))
    mask[:, 16:48] = 255.0
    return {"latents": torch.randn((B, 3, 8, 8, 4), generator=g), "mask": mask,
            "encoder_hidden_states": torch.randn((B, 7, 32), generator=g),
            "uncond_hidden_states": torch.zeros((B, 7, 32))}


def _config(**kw):
    from animate_anything_tpu_torch.train import TrainConfig

    return TrainConfig(learning_rate=1e-4, motion_mask=True, motion_strength=True,
                       cache_latents=True, text_dropout=0.0, adam_eps=1e-4, **kw)


def _full(model):
    """The model's parameters in the one-device layout (a collective)."""
    from animate_anything_tpu_torch.parallel.tensor import full_weights

    return full_weights(model, {n: p.detach().clone() for n, p in model.named_parameters()})


def _grads(mesh) -> dict:
    """One loss and backward of the tiny UNet (tensor-split under ``mesh``):
    every gradient, as this rank holds it."""
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.parallel.tensor import shard_model
    from animate_anything_tpu_torch.train import make_loss_fn
    from animate_anything_tpu_torch.train.trainer import draw_inputs

    unet = _tiny("tiny", "pallas")
    shard_model(unet, mesh)
    batch = _batch(0)
    cfg = _config()
    noise, t, drop = draw_inputs(make_schedule(), cfg, batch["latents"].shape, _gen(100), "cpu")
    loss, _ = make_loss_fn(make_schedule(), cfg)(unet, batch, noise, t, drop)
    loss.backward()
    return {n: p.grad.clone() for n, p in unet.named_parameters()}


def _steps(mesh, kind: str, out_dir=None, resume=None) -> dict:
    """Scenario ``kind``'s steps on the tiny UNet; → metrics, the masters in
    the one-device layout, and the step's checkpoint where asked."""
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.parallel.tensor import full_weights, shard_model
    from animate_anything_tpu_torch.train import create_train_state, make_train_step
    from animate_anything_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    unet = _tiny("tiny", "pallas")
    shard_model(unet, mesh)
    cfg = _config(use_8bit_adam=kind == "8bit",
                  gradient_accumulation_steps=2 if kind == "8bit" else 1)
    state = create_train_state(unet, cfg, mesh=mesh)
    step = make_train_step(make_schedule(), cfg, device="cpu", mesh=mesh)
    if resume:
        restore_checkpoint(resume, state)
    steps = [2] if resume else range(2 if kind == "8bit" else 1)
    metrics = [step(state, _batch(i), _gen(100 + i)) for i in steps]
    path = save_checkpoint(out_dir, state) if out_dir else None
    return {"metrics": metrics, "masters": full_weights(unet, dict(state.masters)),
            "path": path}


# 128 px: at 64 px the tiny SVD UNet's deepest level is 1×1, where a
# GroupNorm over one value makes the gradients ill-conditioned (fp32
# sum-order noise there moves the grad norm by 1e-5 and more)
SVD_ARGS = ["model_size=tiny", "train_data.width=128", "train_data.height=128",
            "train_data.n_sample_frames=3", "train_batch_size=2", "max_train_steps=1",
            "mixed_precision=fp32"]


def _svd_cli(json_path: str, out: str, extra=()) -> str:
    from animate_anything_tpu_torch import cli_svd
    from animate_anything_tpu_torch.core.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                                   "train_svd_mask.yaml"),
                      SVD_ARGS + [f"train_data.json_path={json_path}", f"output_dir={out}",
                                  *extra])
    return cli_svd.main(device="cpu", **cfg.to_dict())


def _worker(out_dir: str, ckpt_w1: str, json_path: str) -> None:
    import torch.distributed as dist

    from animate_anything_tpu_torch.core.mesh import create_mesh

    mesh = create_mesh({"data": 1, "tensor": 2})
    rank = dist.get_rank()
    results = {"forwards": _forwards(mesh), "grads": _grads(mesh)}
    results["full"] = _steps(mesh, "full", os.path.join(out_dir, "ckpt_t2"))
    results["8bit"] = _steps(mesh, "8bit")
    results["resumed_t2"] = _steps(mesh, "full", resume=ckpt_w1)
    results["svd"] = _svd_cli(json_path, os.path.join(out_dir, "svd_t2"), ["mesh.tensor=2"])
    results["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                                    ("jax", "jaxlib", "flax", "animate_anything_tpu"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, results)
    if rank == 0:
        torch.save(every, os.path.join(out_dir, "results.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process reference, then one spawn of 2 gloo ranks."""
    from test_torch_port_svd_train_cli import write_clips

    from animate_anything_tpu_torch.dryrun import spawn_ranks

    out = tmp_path_factory.mktemp("tensor")
    json_path = write_clips(str(out / "clips"), res=128)
    with one_thread():
        ref = {"forwards": _forwards(None), "grads": _grads(None),
               "full": _steps(None, "full", str(out / "ckpt_w1")), "8bit": _steps(None, "8bit"),
               "svd": _svd_cli(json_path, str(out / "svd_w1"))}
        ref["full3"] = _steps(None, "full", resume=ref["full"]["path"])
    spawn_ranks("test_torch_port_tensor_axis:_worker", 2, "cpu", str(out), ref["full"]["path"],
                json_path, timeout=TIMEOUT, group_timeout=GROUP_TIMEOUT)
    return ref, torch.load(out / "results.pt", weights_only=False), out


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["tiny", "odd"])
def test_tensor_split_forward_matches_one_process(runs, kind, impl):
    """Both ranks return the one-process output; at 96 channels the 3-head
    sites stay whole (replicated) and the 6-head ones split."""
    ref, got, _ = runs
    for r in got:
        _close(r["forwards"][f"{kind}.{impl}"], ref["forwards"][f"{kind}.{impl}"],
               f"{kind}.{impl}", rel=REL)
        split = r["forwards"][f"{kind}.{impl}.split"]
        site = "down_blocks.0.attentions.0.transformer_blocks.0."
        assert (f"{site}attn1.to_q.weight" in split) == (kind == "tiny")   # 4 heads, not 3
        assert f"{site}ff.net.2.weight" in split
        assert "down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_out.0.weight" in split
    assert got[0]["jax_modules"] == []


def test_split_gradients_are_slices_and_replicated_ones_agree(runs):
    from animate_anything_tpu_torch.parallel.tensor import TPGroup, local_slice, placement

    ref, got, _ = runs
    plan = placement(_tiny("tiny", "pallas"), 2)
    assert len(plan) > 20
    floor = GRAD_ATOL * max(float(g.abs().max()) for g in ref["grads"].values())
    for name, want in ref["grads"].items():
        for r, res in enumerate(got):
            g = res["grads"][name]
            w = local_slice(want, *plan[name], TPGroup(2, r)) if name in plan else want
            _close(g, w, f"grad {name} rank {r}", atol=floor, rel=REL)
        if name not in plan:         # replicated: the same gradient on both ranks
            assert torch.equal(got[0]["grads"][name], got[1]["grads"][name]), name


def _metrics_close(got, want, what):
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=REL, err_msg=f"{what}.{k}")


def test_tensor_split_step_matches_one_process(runs):
    ref, got, _ = runs
    _metrics_close(got[0]["full"]["metrics"], ref["full"]["metrics"], "full")
    _close(got[0]["full"]["masters"], ref["full"]["masters"], "masters", atol=MASTER_ATOL)
    assert got[1]["full"]["masters"] is None           # gathered on the axis's rank 0


def test_eight_bit_accumulated_steps_under_tensor_two(runs):
    ref, got, _ = runs
    _metrics_close(got[0]["8bit"]["metrics"], ref["8bit"]["metrics"], "8bit")
    _close(got[0]["8bit"]["masters"], ref["8bit"]["masters"], "8bit masters",
           atol=50 * MASTER_ATOL)


def test_checkpoints_move_between_tensor_sizes(runs):
    """Tensor 2's checkpoint is the one-device file (the masters and AdamW's
    moments whole, the GEGLU pairing undone): loaded at one process it gives
    the one-process forward; the one-process file resumed at tensor 2 takes
    the reference's next step."""
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.train import create_train_state, make_train_step
    from animate_anything_tpu_torch.train.checkpoint import STATE_FILE, restore_checkpoint

    ref, got, out = runs
    t2 = torch.load(os.path.join(got[0]["full"]["path"], STATE_FILE), weights_only=True)
    w1 = torch.load(os.path.join(ref["full"]["path"], STATE_FILE), weights_only=True)
    _close(t2["masters"], w1["masters"], "file masters", atol=MASTER_ATOL)
    for key in ("mu", "nu"):
        _close(t2["optimizer"][key], w1["optimizer"][key], f"file {key}", atol=1e-10, rel=1e-4)
    with one_thread(), torch.no_grad():
        unet = _tiny("tiny", "pallas", seed=1)
        state = create_train_state(unet, _config())
        restore_checkpoint(got[0]["full"]["path"], state)
        loaded = unet.eval()(*_inputs())
        unet = _tiny("tiny", "pallas", seed=1)
        state = create_train_state(unet, _config())
        restore_checkpoint(ref["full"]["path"], state)
        _close(loaded, unet.eval()(*_inputs()), "loaded forward", rel=REL)
    _metrics_close(got[0]["resumed_t2"]["metrics"], ref["full3"]["metrics"], "resumed")
    _close(got[0]["resumed_t2"]["masters"], ref["full3"]["masters"], "resumed masters",
           atol=MASTER_ATOL)
    del make_schedule, make_train_step


def test_svd_cli_takes_the_one_process_step_at_tensor_two(runs):
    from safetensors.torch import load_file

    ref, got, _ = runs
    logs, weights = [], []
    for run in (ref["svd"], got[0]["svd"]):
        with open(os.path.join(run, "train_log.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
        weights.append(load_file(os.path.join(run, "pipeline_step_1", "unet",
                                              "diffusion_pytorch_model.safetensors")))
    want, have = logs
    for k in ("loss", "edm_loss", "mask_consistency_loss", "grad_norm"):
        np.testing.assert_allclose(have[0][k], want[0][k], rtol=REL, err_msg=k)
    # the YAML's AdamW (ε 1e-8) turns the sum-order noise of the gradients
    # that GroupNorms make zero by construction into whole updates of either
    # sign: the weights agree within two updates (2·lr), where a slice out
    # of place or an unpaired GEGLU row would be off by the weights' size
    lr = 1e-5                                   # configs/train_svd_mask.yaml
    _close(weights[1], weights[0], "svd pipeline", atol=2 * lr)


# -- against JAX's tensor-sharded step (slow) --------------------------------

def _jax_tp_worker(in_path: str, out_path: str) -> None:
    """One rank of the port's tensor-2 nano UNet: the loss on JAX's draws and
    its backward; rank 0 saves the loss and every gradient whole."""
    import torch.distributed as dist

    from animate_anything_tpu_torch.core.mesh import create_mesh
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.dryrun import nano_unet_config
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel
    from animate_anything_tpu_torch.parallel.tensor import full_weights, shard_model
    from animate_anything_tpu_torch.train import TrainConfig, make_loss_fn

    inp = torch.load(in_path, weights_only=False)
    mesh = create_mesh({"data": 1, "tensor": 2})
    unet = UNet3DConditionModel(nano_unet_config())
    unet.load_state_dict(inp["params"], strict=True)
    shard_model(unet, mesh)
    cfg = TrainConfig(motion_mask=True, motion_strength=True, cache_latents=True)
    loss, metrics = make_loss_fn(make_schedule(), cfg)(unet.eval(), inp["batch"], *inp["draws"])
    loss.backward()
    grads = full_weights(unet, {n: p.grad for n, p in unet.named_parameters()})
    if dist.get_rank() == 0:
        torch.save({"loss": float(loss.detach()), "grads": grads}, out_path)


@pytest.mark.slow
def test_tensor_split_gradients_match_jax_tensor_sharded_step(tmp_path):
    """JAX's nano UNet step (``attn_impl`` "xla") on a ``{data: 1, tensor: 2}``
    mesh of the conftest's virtual devices, its parameters placed by
    ``infer_state_shardings`` (the TP rules), its gradients read off one step
    of an identity optimizer; the port's loss and gradients on 2 gloo ranks
    with the UNet tensor-split, on JAX's draws: the loss 1e-5 relative, every
    gradient 5e-5 absolute (the JAX-vs-port tolerance of the one-device
    gradient test). Slow: JAX compiles the sharded step."""
    import jax
    import jax.numpy as jnp
    import optax

    from animate_anything_tpu.core.mesh import create_mesh as jax_mesh
    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.parallel import infer_state_shardings
    from animate_anything_tpu.train import TrainConfig as JaxConfig
    from animate_anything_tpu.train import make_train_step as jax_step
    from animate_anything_tpu.train.trainer import TrainState
    from test_torch_port_helpers import jax_params, t
    from test_torch_port_trainer import _jax_draws

    from animate_anything_tpu_torch.dryrun import spawn_ranks
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict

    r = np.random.default_rng(8)
    b, f, hw = 2, 3, 4
    mask = np.zeros((b, 8 * hw, 8 * hw), np.float32)
    mask[:, 8:24] = 255.0
    batch = {"latents": r.standard_normal((b, f, hw, hw, 4)).astype(np.float32), "mask": mask,
             "encoder_hidden_states": r.standard_normal((b, 7, 32)).astype(np.float32),
             "uncond_hidden_states": np.zeros((b, 7, 32), np.float32)}
    args = (batch["latents"], np.int32(1), batch["encoder_hidden_states"],
            batch["latents"][:, :1], np.ones((b, 1, hw, hw, 1), np.float32),
            np.ones((b,), np.float32))
    unet = JaxUNet(JaxCfg(**{k: v for k, v in NANO.items()}))
    params = jax_params(unet, *args)
    jcfg = JaxConfig(motion_mask=True, motion_strength=True, cache_latents=True)
    jsched = jax_schedule()
    mesh = jax_mesh({"data": 1, "tensor": 2}, jax.devices()[:2])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=(),
                       tx=optax.identity())
    state = jax.tree_util.tree_map(jax.device_put, state,
                                   infer_state_shardings(state, mesh, min_shard_size=0))
    key = jax.random.PRNGKey(3)
    new_state, want = jax.jit(jax_step(unet, jsched, jcfg))(
        state, jax.tree_util.tree_map(jnp.asarray, batch), key)
    want_grads = unet3d_state_dict(jax.tree_util.tree_map(
        lambda a, p: np.asarray(a) - np.asarray(p), new_state.params, params))
    draws = _jax_draws(key, batch["latents"].shape, jcfg, jsched)
    torch.save({"params": unet3d_state_dict(params), "draws": draws,
                "batch": {k: t(v) for k, v in batch.items()}}, tmp_path / "in.pt")
    spawn_ranks("test_torch_port_tensor_axis:_jax_tp_worker", 2, "cpu", str(tmp_path / "in.pt"),
                str(tmp_path / "out.pt"), timeout=TIMEOUT, group_timeout=GROUP_TIMEOUT)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=REL)
    for name, w in want_grads.items():
        np.testing.assert_allclose(got["grads"][name].numpy(), np.asarray(w), atol=5e-5,
                                   err_msg=name)
