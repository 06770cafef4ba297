"""The frame axis of the port on the CPU (gloo): ``parallel/frame.py`` and
the frame-sharded temporal layers, UNet and request.

- no spawn: the uneven split of 17 frames over 2 and 4 ranks, and the
  UNet's frame layout (rank 0 holds the condition frame);
- then 2 spawned gloo ranks on a ``{data: 1, frame: 2}`` mesh (one spawn for
  the module, one thread a rank), against the single process on the same
  inputs:
  - the all-to-all round trip with uneven frame and position counts;
  - a ``TemporalConvLayer`` and a ``TemporalTransformer`` on 17 frames
    (9 + 8), both ``"pallas"`` (kernels 3, 4 and 5's plain versions, the
    fused temporal path) and ``"xla"`` (the composite path), with producer
    sums and without;
  - a 2-step request of 16 frames (17 inside the UNet) through the tiny
    mask+motion UNet under both configurations, and one of 3 frames, which
    the frame axis does not divide and which runs whole on every rank, as
    JAX's ``shard()`` leaves it;
  - ``cli.main`` with ``mesh: {data: 1, frame: 2}`` (the frame ranks run the
    same rows, as JAX's train step does).

Tolerances (fp32 on both sides; the sides differ only in the order of fp32
sums: GroupNorm statistics summed a slice of positions at a time and then
over the ranks): module outputs and sums 1e-5 of their largest magnitude;
the request's video and latents 1e-5 of theirs (CFG and the first step's
1/√ᾱ amplify the sum order, as in the data axis's test); the loss 1e-5
relative. A padding frame reaching a GroupNorm's sums, the tap conv or a
temporal key moves these by whole percents (the module checks are at 17
frames, where the 8-frame rank would be padded to 9).
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_data_parallel import (GROUP_TIMEOUT, TIMEOUT, _cli_config, _cli_run, _close,
                                           _write_gifs, one_thread)

REL = 1e-5
B = 2


# -- the split (no spawn) ----------------------------------------------------

def test_seventeen_frames_split_unevenly_over_two_and_four_ranks():
    from animate_anything_tpu_torch.parallel.frame import FrameShard, split_counts

    assert split_counts(17, 2) == (9, 8)
    assert split_counts(17, 4) == (5, 4, 4, 4)
    assert split_counts(3, 4) == (1, 1, 1, 0)
    for n in (2, 4):
        request = FrameShard(split_counts(16, n))
        inner = request.leading(1)              # the UNet's condition frame on rank 0
        assert inner.counts == split_counts(17, n)
        shards = [FrameShard(inner.counts, r) for r in range(n)]
        assert [(s.lo, s.hi) for s in shards] == [
            (sum(inner.counts[:r]), sum(inner.counts[:r + 1])) for r in range(n)]
        assert shards[-1].hi == 17


def test_mesh_shard_follows_jax_rule():
    from animate_anything_tpu_torch.core.mesh import Mesh
    from animate_anything_tpu_torch.parallel.frame import mesh_shard

    # no process group: nothing is split
    assert mesh_shard(Mesh({"data": 1, "frame": 2}), 16) is None
    assert mesh_shard(None, 16) is None


# -- the spawned ranks -------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _modules():
    """A temporal conv layer and a temporal transformer (64 channels, 8 heads
    of 8) under both configurations, seeded weights."""
    from animate_anything_tpu_torch.models.attention import TemporalTransformer
    from animate_anything_tpu_torch.models.layers import TemporalConvLayer

    out = {}
    for impl in ("pallas", "xla"):
        torch.manual_seed(3)
        tconv = TemporalConvLayer(64, groups=8, impl=impl)
        tattn = TemporalTransformer(64, 8, 8, groups=8, attn_impl=impl)
        for m in (tconv, tattn):
            for p in m.parameters():
                p.data = torch.randn(p.shape, generator=_gen(p.numel())) * 0.2
            m.eval()
        out[impl] = (tconv, tattn)
    return out


def _module_inputs():
    g = _gen(11)
    x = torch.randn((B * 17, 4, 5, 64), generator=g)      # s = 20 positions
    s1 = x.reshape(B * 17, 20, 64).sum(1)
    return x, (s1, x.reshape(B * 17, 20, 64).square().sum(1))


def _module_outputs(shard=None) -> dict:
    """Both temporal modules on the 17-frame input (this rank's frames under
    ``shard``), with and without producer sums."""
    from animate_anything_tpu_torch.parallel import frame

    x, sums = _module_inputs()
    lo, hi = (0, 17) if shard is None else (shard.lo, shard.hi)
    xl = x.reshape(B, 17, 4, 5, 64)[:, lo:hi].reshape(-1, 4, 5, 64)
    sl = tuple(t.reshape(B, 17, 64)[:, lo:hi].reshape(-1, 64) for t in sums)
    out = {}
    with torch.no_grad(), frame.sharded_frames(shard):
        for impl, (tconv, tattn) in _modules().items():
            out[f"{impl}.conv"] = tconv(xl, 17)
            out[f"{impl}.conv_sums"] = tconv(xl, 17, sl)
            folded = tuple(t.reshape(B, -1, 64).sum(1) for t in sl)
            out[f"{impl}.attn"] = tattn(xl, 17)
            out[f"{impl}.attn_sums"] = tattn(xl, 17, folded)
    return out


def _tiny_unet(impl):
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True, attn_impl=impl)
    unet = init_unet3d_(UNet3DConditionModel(cfg), _gen(0))
    # conv4 of each temporal conv starts at zero (the layer is the identity):
    # give it weights, so the temporal convs reach the video
    for name, p in unet.named_parameters():
        if "conv4" in name:
            p.data = 0.05 * torch.randn(p.shape, generator=_gen(p.numel()))
    return unet


def _request(mesh, impl, frames) -> dict:
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.utils.convert import init_vae_

    vae = init_vae_(AutoencoderKL(VAEConfig.tiny()), _gen(4))
    pipe = LatentToVideoPipeline(_tiny_unet(impl).eval(), vae, schedule=make_schedule(),
                                 mesh=mesh)
    g = _gen(5)
    img = torch.randn((B, 1, 8, 8, 4), generator=g)
    ts = pipe.get_timesteps(2)
    init = pipe.prepare_init_latents(img, frames, ts, g)
    embeds = torch.randn((B, 7, 32), generator=g)
    mask = torch.zeros((B, 1, 8, 8, 1))
    mask[:, :, 2:6] = 1.0
    video, latents = pipe(latents=init, prompt_embeds=embeds, negative_prompt_embeds=embeds * 0,
                          condition_latent=img, mask=mask, motion=[3.0, 5.0], timesteps=ts,
                          guidance_scale=3.0)
    return {"video": video, "latents": latents}


def _requests(mesh) -> dict:
    return {f"{impl}.{frames}": _request(mesh, impl, frames)
            for impl in ("pallas", "xla") for frames in (16, 3)}


def _round_trip(shard) -> dict:
    """A (b, 17, s, c) tensor's frames through ``to_positions`` and back, at
    s = 7 (4 + 3 positions)."""
    whole = torch.arange(B * 17 * 7 * 3, dtype=torch.float32).reshape(B, 17, 7, 3)
    mine = whole[:, shard.lo:shard.hi]
    pos = shard.to_positions(mine)
    back = shard.to_frames(pos, 7)
    lo = sum((4, 3)[:shard.rank])
    return {"positions": torch.equal(pos, whole[:, :, lo:lo + pos.shape[2]]),
            "back": torch.equal(back, mine), "gather": torch.equal(shard.gather(mine), whole)}


def _worker(out_dir: str, cli_cfg: dict) -> None:
    import torch.distributed as dist

    from animate_anything_tpu_torch.core.mesh import create_mesh
    from animate_anything_tpu_torch.parallel.frame import FrameShard, mesh_shard, split_counts

    mesh = create_mesh({"data": 1, "frame": 2})
    r = mesh.rank("frame")
    shard17 = FrameShard(split_counts(17, 2), r, mesh.group("frame"))
    results = {"round_trip": _round_trip(shard17),
               "modules": _module_outputs(shard17),
               "splits": {f: None if mesh_shard(mesh, f) is None else mesh_shard(mesh, f).counts
                          for f in (16, 3)},
               "requests": _requests(mesh),
               "cli": _cli_run(cli_cfg)["run"],
               "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in
                                     ("jax", "jaxlib", "flax", "animate_anything_tpu"))}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, results)
    if dist.get_rank() == 0:
        torch.save(every, os.path.join(out_dir, "results.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process reference, then one spawn of 2 gloo ranks."""
    from animate_anything_tpu_torch.dryrun import spawn_ranks

    out = tmp_path_factory.mktemp("frame")
    gifs = _write_gifs(out / "gifs")
    with one_thread():
        ref = {"modules": _module_outputs(), "requests": _requests(None),
               "cli": _cli_run(_cli_config(gifs, str(out / "cli_w1")))["run"]}
    cfg = _cli_config(gifs, str(out / "cli_f2"))
    cfg["mesh"] = {"data": 1, "frame": 2}
    spawn_ranks("test_torch_port_frame_axis:_worker", 2, "cpu", str(out), cfg,
                timeout=TIMEOUT, group_timeout=GROUP_TIMEOUT)
    return ref, torch.load(out / "results.pt", weights_only=False)


def test_all_to_all_moves_uneven_frames_and_positions(runs):
    _, got = runs
    for r in got:
        assert r["round_trip"] == {"positions": True, "back": True, "gather": True}
        assert r["jax_modules"] == []


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_temporal_modules_on_seventeen_split_frames_match_whole(runs, impl):
    """Each rank's frames of both temporal modules (and kernel 3's and 4's
    output sums under ``"pallas"``) equal the whole run's frames."""
    ref, got = runs
    counts = (9, 8)
    for key in ("conv", "conv_sums", "attn", "attn_sums"):
        want_y, want_s = ref["modules"][f"{impl}.{key}"]
        for r, res in enumerate(got):
            lo, hi = sum(counts[:r]), sum(counts[:r + 1])
            y, sums = res["modules"][f"{impl}.{key}"]
            rows = slice(None)
            wy = want_y.reshape(B, 17, *want_y.shape[1:])[:, lo:hi].reshape(y.shape)
            _close(y[rows], wy, f"{impl}.{key} rank {r}", rel=REL)
            if want_s is None:
                assert sums is None
                continue
            for t, w in zip(sums, want_s):
                w = w.reshape(B, 17, -1)[:, lo:hi].reshape(t.shape)
                _close(t, w, f"{impl}.{key} sums rank {r}", rel=REL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_frame_sharded_request_matches_one_process(runs, impl):
    """16 frames over 2 ranks (the UNet's 17 as 9 + 8): every rank returns
    the whole video, equal to the one-process request's."""
    ref, got = runs
    assert [r["splits"] for r in got] == [{16: (8, 8), 3: None}] * 2
    want = ref["requests"][f"{impl}.16"]
    for r in got:
        have = r["requests"][f"{impl}.16"]
        assert have["video"].shape == (B, 16, 64, 64, 3)
        for k in ("video", "latents"):
            _close(have[k], want[k], f"{impl} {k}", rel=REL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_frames_the_axis_does_not_divide_run_whole(runs, impl):
    ref, got = runs
    want = ref["requests"][f"{impl}.3"]
    for r in got:
        for k in ("video", "latents"):
            _close(r["requests"][f"{impl}.3"][k], want[k], f"{impl} {k}", rel=REL)


def test_cli_main_runs_the_frame_ranks_on_the_same_rows(runs):
    """``cli.main`` at ``{data: 1, frame: 2}`` takes the one-process step."""
    import json

    ref, got = runs
    logs = []
    for run in (ref["cli"], got[0]["cli"]):
        with open(os.path.join(run, "train_log.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    want, have = logs
    assert [r["step"] for r in have] == [r["step"] for r in want] == [1]
    np.testing.assert_allclose(have[0]["loss"], want[0]["loss"], rtol=REL)
    np.testing.assert_allclose(have[0]["grad_norm"], want[0]["grad_norm"], rtol=REL)
