"""The data axis of the port on the CPU (gloo): ``core/mesh.py``,
``parallel/partition.py`` and the data-parallel train steps, checkpoints and
request.

- ``resolve_mesh_shape`` against JAX's ``create_mesh`` over 1-8 of the
  conftest's virtual devices (sizes and errors alike); at world size 1 a
  frame or tensor axis above 1 wants more processes, as any bad mesh;
- the ZeRO plan: every element in exactly one rank's 256-aligned slice,
  arrays under 2**14 elements replicated, each rank's optimizer bytes about
  1/n of the whole;
- then 2 spawned gloo ranks (one spawn for the module, one thread a rank)
  on the tiny UNet, each step's draws the global batch's from one generator,
  against the single process on the same global batch: two full-finetune
  steps, two 8-bit AdamW steps, two LoRA steps, a
  ``gradient_accumulation_steps: 2`` update, a checkpoint written at world 2
  resumed at world 1 and one written at world 1 resumed at world 2, the
  2-step data-sharded pipeline (tiny VAE), ``cli.main`` with
  ``cache_latents`` (the cache encoded a share a rank); the workers import no
  JAX.

Tolerances (fp32; the two sides differ only in the order of fp32 sums: each
rank's batch-1 backward and the all-reduce against one batch-2 backward; AdamW
at lr 1e-4 and ε 1e-4, so that u = m/(√v + ε) does not turn the sum-order
noise of a near-zero gradient into a whole update):
- losses and grad norms 1e-5 relative;
- masters 1e-6 absolute, 1 % of an update (worst seen 1.2e-7);
- moments and accumulators 1e-4 of each array's largest magnitude (worst
  seen 3.5e-6) plus 1e-10 (the temporal convs in front of a zero-initialised
  ``conv4`` have an exact gradient of 0, and sum-order noise of ~1e-13);
- 8-bit: masters 5e-5, half an update (one quantization level of ν near
  zero moves √ν by a large factor; worst seen 1.7e-5), dequantized moments
  within two levels of each array's scale, 2/127 of max|m| and 2/255 of
  max ν (worst seen 0.8 and 1.0 level);
- the pipeline's video and latents 1e-5 of their largest magnitude (worst
  seen 1.5e-6; CFG and the first step's 1/√ᾱ amplify the sum order).
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

LR = 1e-4
MASTER_ATOL, MOMENT_REL, MOMENT_ATOL = 1e-6, 1e-4, 1e-10
B = 2
# a hung collective fails after GROUP_TIMEOUT, the whole spawn after TIMEOUT
GROUP_TIMEOUT, TIMEOUT = 120.0, 300.0


@contextlib.contextmanager
def one_thread():
    """The reference runs on one thread, as each spawned rank does: beside the
    suite's other workers, a thread pool per op oversubscribes the cores and
    a step slows tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- the mesh and the plan (no spawn) ------------------------------------------

MESH_SHAPES = [None, {"data": -1}, {"data": 2}, {"data": -1, "frame": 2},
               {"data": 2, "frame": 2, "tensor": 2}, {"data": -1, "tensor": -1},
               {"data": 3}, {"data": -1, "frame": 3}, {"frame": 2, "data": -1}, {"data": 1}]


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_resolves_as_jax(n):
    import jax

    from animate_anything_tpu.core.mesh import create_mesh as jax_mesh
    from animate_anything_tpu_torch.core.mesh import resolve_mesh_shape

    devices = jax.devices()[:n]
    assert len(devices) == n
    for shape in MESH_SHAPES:
        try:
            m = jax_mesh(shape, devices)
            want = dict(zip(m.axis_names, m.devices.shape))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                resolve_mesh_shape(shape, n)
            continue
        assert resolve_mesh_shape(shape, n) == want, shape


def test_create_mesh_runs_the_data_axis_alone():
    from animate_anything_tpu_torch.core import mesh
    from animate_anything_tpu_torch.data.loader import check_mesh, device_prefetch

    m = mesh.create_mesh({"data": -1})
    assert m.axes == {"data": 1} and m.device_mesh is None and m.group() is None
    assert mesh.create_mesh().axes == {"data": 1}
    # the frame and tensor axes run: at world size 1 an axis above 1 needs
    # more processes, as every bad mesh, and nothing is refused as unported
    for shape in ({"data": 1, "frame": 2}, {"tensor": 2}, {"data": 2}):
        for make in (mesh.create_mesh, check_mesh,
                     lambda s: next(device_prefetch(iter([{"x": np.zeros(2)}]), device="cpu",
                                                    mesh=s))):
            with pytest.raises(ValueError, match="item 21a") as e:
                make(shape)
            assert not isinstance(e.value, NotImplementedError)
    assert not hasattr(mesh, "AxisNotPorted")
    three = mesh.create_mesh({"data": 1, "frame": 1, "tensor": 1})
    assert three.axes == {"data": 1, "frame": 1, "tensor": 1} and three.device_mesh is None
    assert [three.size(a) for a in ("data", "frame", "tensor")] == [1, 1, 1]
    check_mesh({"data": -1, "frame": 1})
    x = torch.arange(12).reshape(6, 2)
    assert mesh.shard_batch({"x": x, "s": ["a"] * 6}, m)["x"] is x


NUMELS = {"small": 100, "edge": 2 ** 14 - 1, "at": 2 ** 14, "odd": 2 ** 14 + 1,
          "big": 1_000_003, "blocks": 256 * 7 * 9}


@pytest.mark.parametrize("n", range(1, 9))
def test_zero_plan_covers_every_element_once(n):
    from animate_anything_tpu_torch.parallel.partition import (BLOCK, MIN_SHARD_SIZE, ZeroPlan,
                                                               zero_chunks)

    chunks = zero_chunks(NUMELS, n)
    assert set(chunks) == {k for k, v in NUMELS.items() if v >= MIN_SHARD_SIZE}
    plans = [ZeroPlan(NUMELS, chunks, n, r) for r in range(n)]
    for name in chunks:
        assert chunks[name] % BLOCK == 0
        seen = np.zeros(NUMELS[name], int)
        for p in plans:
            lo, hi = p.range(name)
            assert lo % BLOCK == 0 and lo <= hi
            seen[lo:hi] += 1
        assert (seen == 1).all(), name


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("eight_bit", [False, True])
def test_each_rank_holds_about_a_nth_of_the_optimizer(n, eight_bit):
    from animate_anything_tpu_torch.ops.adam8bit import AdamW8bit
    from animate_anything_tpu_torch.parallel.partition import ZeroPlan, zero_chunks
    from animate_anything_tpu_torch.train.trainer import AdamW, TrainConfig

    masters = {k: torch.zeros(v) for k, v in NUMELS.items()}
    cfg = TrainConfig(use_8bit_adam=eight_bit, gradient_accumulation_steps=2)
    cls = AdamW8bit if eight_bit else AdamW
    whole = cls(cfg, masters).state_bytes()
    chunks = zero_chunks(NUMELS, n)
    per_rank = []
    for r in range(n):
        opt = cls(cfg, masters, ZeroPlan(NUMELS, chunks, n, r))
        per_rank.append(opt.state_bytes())
        assert sum(t.numel() for t in opt.acc.values()) <= sum(NUMELS.values())
    replicated = sum(v for k, v in NUMELS.items() if k not in chunks)
    per_elem = whole / sum(NUMELS.values())
    assert sum(per_rank) >= whole
    for got in per_rank:
        bound = (sum(NUMELS[k] for k in chunks) / n + 256 * len(chunks) + replicated) * per_elem
        assert got <= bound + 8 * len(chunks)
    assert max(per_rank) <= whole / n + replicated * per_elem * (1 - 1 / n) + 1e4


# -- the spawned ranks -------------------------------------------------------

def _tiny_unet():
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    unet = UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True, motion_strength=True))
    return init_unet3d_(unet, torch.Generator().manual_seed(0))


def _batch(step: int) -> dict:
    """Global batch ``step`` (B rows)."""
    g = torch.Generator().manual_seed(10 + step)
    mask = torch.zeros((B, 64, 64))
    mask[:, 16:48] = 255.0
    return {"latents": torch.randn((B, 3, 8, 8, 4), generator=g), "mask": mask,
            "encoder_hidden_states": torch.randn((B, 7, 32), generator=g),
            "uncond_hidden_states": torch.zeros((B, 7, 32))}


def _config(**kw):
    from animate_anything_tpu_torch.train import TrainConfig

    return TrainConfig(learning_rate=LR, motion_mask=True, motion_strength=True,
                       cache_latents=True, text_dropout=0.5, adam_eps=1e-4, **kw)


def _state(kind: str, mesh):
    """(state, step function) of scenario ``kind`` on a fresh tiny UNet."""
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.models import lora
    from animate_anything_tpu_torch.train import (create_lora_train_state, create_train_state,
                                                  make_lora_train_step, make_train_step)

    unet = _tiny_unet()
    sched = make_schedule()
    if kind == "lora":
        cfg = _config()
        lcfg = lora.LoraConfig(rank=4, targets=("UNet3DConditionModel",), dropout=0.25)
        params = lora.lora_params(unet)
        tree = {"unet_lora": lora.init_lora_params(torch.Generator().manual_seed(7), params,
                                                   lcfg)}
        unet.requires_grad_(False)
        state = create_lora_train_state(tree, cfg, mesh=mesh, min_shard_size=256)
        base = {p: params[p].detach().clone() for p in tree["unet_lora"]}
        return state, make_lora_train_step(sched, cfg, unet, base, lcfg, device="cpu",
                                           mesh=mesh)
    cfg = _config(use_8bit_adam=kind == "8bit",
                  gradient_accumulation_steps=2 if kind == "accum" else 1)
    return (create_train_state(unet, cfg, mesh=mesh),
            make_train_step(sched, cfg, device="cpu", mesh=mesh))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _snapshot(state, metrics) -> dict:
    """Copies: a one-device optimizer's ``state_dict`` is its live tensors."""
    return _copy({"metrics": metrics, "masters": state.masters,
                  "optimizer": state.optimizer.state_dict(), "step": state.step})


def _run(kind: str, mesh, steps=range(2), state=None) -> dict:
    """Scenario ``kind``'s steps on this process's rows of each global
    batch; → the metrics and the whole state after the last."""
    from animate_anything_tpu_torch.core.mesh import shard_batch

    if state is None:
        state, fn = _state(kind, mesh)
    else:
        _, fn = _state(kind, mesh)
    metrics = []
    for i in steps:
        batch = _batch(i) if mesh is None else shard_batch(_batch(i), mesh)
        metrics.append(fn(state, batch, torch.Generator().manual_seed(100 + i)))
    return state, _snapshot(state, metrics)


def _pipeline(mesh) -> dict:
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import init_vae_

    vae = init_vae_(AutoencoderKL(VAEConfig.tiny()), torch.Generator().manual_seed(4))
    pipe = LatentToVideoPipeline(_tiny_unet().eval(), vae, schedule=make_schedule(), mesh=mesh)
    g = torch.Generator().manual_seed(5)
    img = torch.randn((B, 1, 8, 8, 4), generator=g)
    ts = pipe.get_timesteps(2)
    init = pipe.prepare_init_latents(img, 3, ts, g)
    embeds = torch.randn((B, 7, 32), generator=g)
    video, latents = pipe(latents=init, prompt_embeds=embeds, negative_prompt_embeds=embeds * 0,
                          condition_latent=img, mask=torch.ones((B, 1, 8, 8, 1)),
                          motion=[3.0, 5.0], timesteps=ts, guidance_scale=3.0)
    return {"video": video, "latents": latents}


class _Recorded:
    """A dataset of 10 items that records which it decoded."""

    def __init__(self):
        self.read = []

    def __len__(self):
        return 10

    def __getitem__(self, i):
        self.read.append(i)
        return {"x": np.full((2,), i, np.float32), "caption": f"c{i}"}


def _loader_rows(mesh) -> dict:
    """Two epochs of a global batch of 4 (drop_last), and the first batch of
    an unshuffled loader through ``device_prefetch``: what this process
    yielded and decoded."""
    from animate_anything_tpu_torch.data import DataLoader, device_prefetch

    ds = _Recorded()
    loader = DataLoader(ds, batch_size=4, seed=3, mesh=mesh)
    batches = [b["x"][:, 0].tolist() for _ in range(2) for b in loader]
    ordered = DataLoader(_Recorded(), batch_size=4, shuffle=False, mesh=mesh)
    pre = next(device_prefetch(iter(ordered), device="cpu", mesh=mesh))
    return {"batches": batches, "read": sorted(ds.read),
            "prefetch": (pre["x"][:, 0].tolist(), pre["caption"])}


CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "tiny_smoke.yaml")


def _write_gifs(d) -> str:
    """Two 6-frame 32 px gifs with a moving red box."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        base = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        frames = []
        for i in range(6):
            fr = base.copy()
            fr[4:12, (2 + 3 * i):(8 + 3 * i)] = [255, 0, 0]
            frames.append(Image.fromarray(fr))
        frames[0].save(os.path.join(d, f"{name}.gif"), save_all=True, append_images=frames[1:],
                       duration=100, loop=0)
    return str(d)


def _cli_config(gifs: str, out: str) -> dict:
    """``configs/tiny_smoke.yaml`` with ``cache_latents``: one step at the
    global batch 2, every process on the data axis."""
    from animate_anything_tpu_torch.core.config import load_config

    return load_config(CONFIG, [f"train_data.path={gifs}", f"output_dir={out}",
                                "cache_latents=true", "train_batch_size=2", "max_train_steps=1",
                                "save_pretrained_model=false", "mesh.data=-1"]).to_dict()


def _cli_run(cfg: dict) -> dict:
    """``cli.main`` on the CPU; → its run directory and the items this
    process encoded into the latent cache."""
    from unittest import mock

    from animate_anything_tpu_torch import cli
    from animate_anything_tpu_torch.data import CachedDataset

    encoded, save = [], CachedDataset.save_item

    def record(cache_dir, index, item):
        encoded.append(index)
        return save(cache_dir, index, item)

    with mock.patch.object(CachedDataset, "save_item", staticmethod(record)):
        run = cli.main(device="cpu", **cfg)
    return {"run": run, "encoded": encoded}


def _worker(out_dir: str, ckpt_w1: str, cli_cfg: dict) -> None:
    """Every scenario on this rank of a {data: 2} mesh; rank 0 saves."""
    import torch.distributed as dist

    from animate_anything_tpu_torch.core.mesh import create_mesh
    from animate_anything_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    mesh = create_mesh({"data": -1})
    results = {}
    for kind in ("full", "8bit", "lora", "accum"):
        state, results[kind] = _run(kind, mesh)
        if kind == "full":
            save_checkpoint(os.path.join(out_dir, "ckpt_w2"), state)
    state, _ = _state("full", mesh)
    restore_checkpoint(ckpt_w1, state)
    results["resumed_w2"] = _run("full", mesh, steps=[2], state=state)[1]
    results["pipeline"] = _pipeline(mesh)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, _loader_rows(mesh))
    results["loader"] = rows
    cli_run = _cli_run(cli_cfg)
    encoded = [None] * dist.get_world_size()
    dist.all_gather_object(encoded, cli_run["encoded"])
    results["cli"] = {"run": cli_run["run"], "encoded": encoded}
    results["plan"] = {"sharded": len(state.optimizer.plan.chunks),
                       "bytes": state.optimizer.state_bytes()}
    results["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in
                                    ("jax", "jaxlib", "flax", "animate_anything_tpu"))
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(out_dir, "results.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process reference (3 full steps, its world-1 checkpoint
    after 2), then one spawn of 2 gloo ranks over every scenario."""
    from animate_anything_tpu_torch.dryrun import spawn_ranks
    from animate_anything_tpu_torch.train.checkpoint import save_checkpoint

    out = tmp_path_factory.mktemp("dp")
    ref = {}
    with one_thread():
        for kind in ("8bit", "lora", "accum"):
            ref[kind] = _run(kind, None)[1]
        state, ref["full"] = _run("full", None)
        w1 = save_checkpoint(str(out / "ckpt_w1"), state)
        ref["full3"] = _run("full", None, steps=[2], state=state)[1]
        ref["pipeline"] = _pipeline(None)
        gifs = _write_gifs(out / "gifs")
        ref["cli"] = _cli_run(_cli_config(gifs, str(out / "cli_w1")))
    spawn_ranks("test_torch_port_data_parallel:_worker", 2, "cpu", str(out), w1,
                _cli_config(gifs, str(out / "cli_w2")), timeout=TIMEOUT,
                group_timeout=GROUP_TIMEOUT)
    return ref, torch.load(out / "results.pt", weights_only=False), out


def _close(got, want, what, atol=0.0, rel=0.0):
    """Each tensor within ``atol`` plus ``rel`` of its own largest magnitude."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}", atol, rel)
    elif isinstance(want, torch.Tensor):
        w = want.double().numpy()
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(got.double().numpy(), w, atol=atol + rel * scale + 1e-30,
                                   rtol=0, err_msg=what)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=what)
    elif want is not None:
        assert got == want, what


def _state_close(got, want, what, master_atol=MASTER_ATOL):
    assert got["step"] == want["step"]
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        _close(g, w, f"{what}.metrics")
    _close(got["masters"], want["masters"], f"{what}.masters", atol=master_atol)
    _close(got["optimizer"], want["optimizer"], f"{what}.optimizer", MOMENT_ATOL, MOMENT_REL)


@pytest.mark.parametrize("kind", ["full", "lora", "accum"])
def test_data_parallel_steps_match_one_process(runs, kind):
    ref, got, _ = runs
    _state_close(got[kind], ref[kind], kind)
    start, _ = _state(kind, None)
    assert any(not torch.equal(got[kind]["masters"][k], start.masters[k])
               for k in start.masters)


def test_data_parallel_8bit_steps_match_one_process(runs):
    from animate_anything_tpu_torch.ops.adam8bit import dequantize

    ref, got, _ = runs
    g, w = got["8bit"], ref["8bit"]
    for gm, wm in zip(g["metrics"], w["metrics"], strict=True):
        _close(gm, wm, "8bit.metrics")
    _close(g["masters"], w["masters"], "8bit.masters", atol=50 * MASTER_ATOL)
    for q, sc, levels in (("m_q", "m_scale", 127), ("v_q", "v_scale", 255)):
        for k in w["optimizer"][q]:
            _close(dequantize(g["optimizer"][q][k], g["optimizer"][sc][k]),
                   dequantize(w["optimizer"][q][k], w["optimizer"][sc][k]), f"8bit.{q}.{k}",
                   MOMENT_ATOL, 2.0 / levels)


def test_checkpoints_move_between_world_sizes(runs):
    """World 2's checkpoint resumed at world 1, and world 1's at world 2,
    take the reference's third step."""
    from animate_anything_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

    ref, got, out = runs
    with one_thread():
        state, _ = _state("full", None)
        restore_checkpoint(latest_checkpoint(str(out / "ckpt_w2")), state)
        _close(_copy(state.optimizer.state_dict()), ref["full"]["optimizer"], "w2 file",
               MOMENT_ATOL, MOMENT_REL)
        _, resumed_w1 = _run("full", None, steps=[2], state=state)
    for resumed in (resumed_w1, got["resumed_w2"]):
        _state_close(resumed, ref["full3"], "resumed")


def test_data_sharded_pipeline_matches_one_process(runs):
    ref, got, _ = runs
    assert got["pipeline"]["video"].shape == (B, 3, 64, 64, 3)
    assert got["pipeline"]["latents"].shape == (B, 3, 8, 8, 4)
    for k in ("video", "latents"):
        _close(got["pipeline"][k], ref["pipeline"][k], k, rel=1e-5)


def test_each_rank_decodes_only_its_rows(runs):
    _, got, _ = runs
    one = _loader_rows(None)
    r0, r1 = got["loader"]
    assert [a + b for a, b in zip(r0["batches"], r1["batches"], strict=True)] == one["batches"]
    assert sorted(r0["read"] + r1["read"]) == one["read"]
    for r in (r0, r1):          # a rank decodes its rows and no other
        assert r["read"] == sorted(int(v) for batch in r["batches"] for v in batch)
    assert r0["prefetch"] == ([0.0, 1.0], ["c0", "c1"])
    assert r1["prefetch"] == ([2.0, 3.0], ["c2", "c3"])


def test_cache_latents_is_shared_out_over_the_ranks(runs):
    """``cli.main`` with ``cache_latents`` on 2 ranks: rank r encodes the items
    i ≡ r (mod 2), the cache equals the one-process run's (each item encoded
    alone at fp32 by the same ops: equal to 1e-6 of its largest magnitude),
    and the one step at the global batch 2 takes the one-process step's
    loss (1e-5 relative); rank 0 alone logs."""
    import json

    ref, got, _ = runs
    assert ref["cli"]["encoded"] == [0, 1]
    assert got["cli"]["encoded"] == [[0], [1]]
    caches = [os.path.join(r["run"], "cached_latents") for r in (ref["cli"], got["cli"])]
    names = sorted(os.listdir(caches[0]))
    assert names == ["cached_00000000.npz", "cached_00000001.npz"]
    assert sorted(os.listdir(caches[1])) == names
    for name in names:
        with np.load(os.path.join(caches[0], name)) as w, \
                np.load(os.path.join(caches[1], name)) as g:
            assert set(g.files) == set(w.files) == {"latents", "mask", "prompt_ids"}
            for k in w.files:
                _close(torch.from_numpy(g[k]), torch.from_numpy(w[k]), f"{name}.{k}", rel=1e-6)
    logs = []
    for r in (ref["cli"], got["cli"]):
        with open(os.path.join(r["run"], "train_log.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    want, have = logs
    assert [r["step"] for r in have] == [r["step"] for r in want] == [1]
    np.testing.assert_allclose(have[0]["loss"], want[0]["loss"], rtol=1e-5)


def test_the_workers_shard_the_state_and_import_no_jax(runs):
    ref, got, _ = runs
    assert got["jax_modules"] == []
    assert got["plan"]["sharded"] > 10
    whole = sum(t.numel() * 4 * 2 for t in ref["full"]["masters"].values())
    # the tiny UNet's many arrays under 2**14 elements stay whole on each rank
    assert whole / 2 < got["plan"]["bytes"] < 0.75 * whole


# -- the slow tier: against JAX's sharded step ----------------------------------

def _jax_dp_worker(inputs_path: str, out_path: str) -> None:
    """A rank of the port's data-parallel step on JAX's weights and draws."""
    import torch.distributed as dist

    from animate_anything_tpu_torch.core.mesh import create_mesh, shard_batch
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.train import TrainConfig, create_train_state, trainer

    inp = torch.load(inputs_path, weights_only=False)
    mesh = create_mesh({"data": -1})
    model = UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True, motion_strength=True))
    model.load_state_dict(inp["state_dict"], strict=True)
    cfg = TrainConfig(**inp["config"])
    state = create_train_state(model, cfg, mesh=mesh)
    seen = {}

    def spy(orig):
        def step(grads, masters):
            seen.update({k: v.detach().clone() for k, v in grads.items() if v is not None})
            return orig(grads, masters)
        return step

    state.optimizer.step = spy(state.optimizer.step)
    trainer.draw_inputs = lambda *a, **k: inp["draws"]
    step = trainer.make_train_step(make_schedule(), cfg, device="cpu", mesh=mesh)
    metrics = step(state, shard_batch(inp["batch"], mesh), torch.Generator())
    masters = {k: v.clone() for k, v in state.masters.items()}
    if dist.get_rank() == 0:
        torch.save({"metrics": metrics, "grads": seen, "masters": masters}, out_path)


@pytest.mark.slow
def test_data_parallel_step_matches_jax_sharded_step(tmp_path):
    """The port's 2-rank step against JAX's ``make_train_step`` jitted over a
    ``{data: 2}`` mesh of the virtual CPU devices, its state placed by
    ``infer_state_shardings`` (ZeRO moments), on the same weights, global
    batch and draws (JAX's rng splits reproduced): metrics 1e-5 relative,
    the averaged gradients 5e-5 (as the one-device gradient test), the
    parameters after AdamW (lr 1e-4, ε 1e-4) 5e-5, half an update.
    Slow: the sharded JAX step compiles for minutes."""
    import jax
    import jax.numpy as jnp
    import optax

    from animate_anything_tpu.core.mesh import create_mesh as jax_mesh
    from animate_anything_tpu.core.mesh import shard_batch as jax_shard
    from animate_anything_tpu.diffusion import make_schedule as jax_schedule
    from animate_anything_tpu.models import UNet3DConditionModel as JaxUNet
    from animate_anything_tpu.models import UNet3DConfig as JaxCfg
    from animate_anything_tpu.parallel import infer_state_shardings
    from animate_anything_tpu.train import TrainConfig as JaxConfig
    from animate_anything_tpu.train import create_train_state as jax_state
    from animate_anything_tpu.train import make_train_step as jax_step
    from animate_anything_tpu.train.trainer import TrainState
    from animate_anything_tpu_torch.dryrun import spawn_ranks
    from animate_anything_tpu_torch.utils.convert import unet3d_state_dict
    from test_torch_port_helpers import jax_params
    from test_torch_port_trainer import _jax_draws

    batch = {k: v.numpy() for k, v in _batch(0).items()}
    kw = dict(motion_mask=True, motion_strength=True)
    args = (batch["latents"], np.int32(1), batch["encoder_hidden_states"],
            batch["latents"][:, :1], np.ones((B, 1, 8, 8, 1), np.float32),
            np.ones((B,), np.float32))
    unet = JaxUNet(JaxCfg.tiny(attn_impl="xla", **kw))
    params = jax_params(unet, *args)
    conf = dict(learning_rate=LR, adam_eps=1e-4, cache_latents=True, text_dropout=0.5, **kw)
    jcfg = JaxConfig(**conf)
    jsched = jax_schedule()
    mesh = jax_mesh({"data": 2}, jax.devices()[:2])
    state = jax_state(params, jcfg)
    state = jax.tree_util.tree_map(jax.device_put, state, infer_state_shardings(state, mesh))
    key = jax.random.PRNGKey(7)
    new_state, want = jax.jit(jax_step(unet, jsched, jcfg))(
        state, jax_shard(jax.tree_util.tree_map(jnp.asarray, batch), mesh), key)
    ident = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=(),
                       tx=optax.identity())
    g_state, _ = jax.jit(jax_step(unet, jsched, jcfg))(
        ident, jax_shard(jax.tree_util.tree_map(jnp.asarray, batch), mesh), key)
    want_grads = unet3d_state_dict(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), g_state.params, params))

    torch.save({"state_dict": unet3d_state_dict(params), "config": conf,
                "draws": _jax_draws(key, batch["latents"].shape, jcfg, jsched),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp_path / "inputs.pt")
    spawn_ranks("test_torch_port_data_parallel:_jax_dp_worker", 2, "cpu",
                str(tmp_path / "inputs.pt"), str(tmp_path / "out.pt"), timeout=TIMEOUT,
                group_timeout=GROUP_TIMEOUT)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    for k in want:
        np.testing.assert_allclose(got["metrics"][k], float(want[k]), rtol=1e-5, err_msg=k)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want_grads[name], atol=5e-5, err_msg=name)
    new = unet3d_state_dict(jax.tree_util.tree_map(np.asarray, new_state.params))
    for name, p in got["masters"].items():
        np.testing.assert_allclose(p.numpy(), new[name].numpy(), atol=5e-5, err_msg=name)
