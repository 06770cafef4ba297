"""The multi-device dry run and the rank launcher — the port of
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n, device="cuda")`` starts ``n`` ranks in one process
group (NCCL over ``n`` GPUs, or gloo processes for ``device="cpu"``; it
raises when fewer than ``n`` GPUs are present and never drops to the CPU)
and on each runs JAX's nano UNet (two blocks, 32/64 channels, motion mask
and strength) through one ZeRO-sharded full-finetune step on a global batch
split over ``data`` (a finite loss), then a 2-step ``LatentToVideoPipeline``
request with the tiny VAE, its batch over ``data`` and its frames over
``frame`` (a finite video). The mesh factors n as JAX's does
(``mesh_factors``): tensor 2 where 8 | n, frame 2 where 2 | n, the rest
data, so {data: n/2, frame: 2} at n = 4 and {data: 2, frame: 2, tensor: 2}
at n = 8; the UNet is tensor-split (``parallel/tensor.shard_model``) for
both the step and the request.

``spawn_ranks(target, n, device, *args)`` is the launcher the dry run, the
tests and ``chip_smoke.py`` share: ``n`` fresh processes
(``torch.multiprocessing``, start method spawn) join one group through a
``FileStore`` in a temporary directory (no network), each calls
``target(*args)`` (``"module:function"``), and the whole run, collectives
included, fails at ``timeout`` instead of hanging. This module imports
nothing of JAX, so its children do not either.

    python -m animate_anything_tpu_torch.dryrun N [--device cpu]
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def _rank_entry(rank: int, n: int, device: str, store_dir: str, target: str, args: tuple,
                timeout: float) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    store = dist.FileStore(os.path.join(store_dir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        module, name = target.split(":")
        getattr(importlib.import_module(module), name)(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target: str, n: int, device: str = "cuda", *args, timeout: float = 300.0,
                group_timeout: float = 120.0) -> None:
    """Run ``target(*args)`` on ``n`` ranks of a fresh process group (rank r
    on GPU r for ``device="cuda"``); raise if a rank raises, a collective
    waits past ``group_timeout`` seconds, or the run outlasts ``timeout``
    seconds (every child is killed then)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"spawn_ranks: {n} ranks need {n} GPUs, "
                           f"{torch.cuda.device_count()} present (pass device='cpu' for gloo)")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks_") as store_dir:
        ctx = mp.start_processes(_rank_entry,
                                 args=(n, device, store_dir, target, args, group_timeout),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {target} on {n} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def nano_unet_config():
    """JAX's dry-run UNet (``__graft_entry__.py:109-119``)."""
    from animate_anything_tpu_torch.models.unet3d import UNet3DConfig

    return UNet3DConfig(block_out_channels=(32, 64),
                        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
                        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
                        layers_per_block=1, cross_attention_dim=32, attention_head_dim=8,
                        norm_num_groups=8, motion_mask=True, motion_strength=True)


def mesh_factors(n: int) -> dict:
    """JAX's dry-run mesh over n devices (``__graft_entry__.py:97-101``):
    tensor 2 when 8 | n, frame 2 when 2 | n·/tensor, the rest data."""
    tensor = 2 if n % 8 == 0 else 1
    frame = 2 if (n // tensor) % 2 == 0 else 1
    return {"data": n // (tensor * frame), "frame": frame, "tensor": tensor}


def _dryrun_rank(device: str, out_path: str) -> None:
    """One rank of the dry run: the ZeRO step, then the sharded request."""
    from animate_anything_tpu_torch.core.mesh import create_mesh, is_main_process, shard_batch
    from animate_anything_tpu_torch.parallel.tensor import shard_model
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline
    from animate_anything_tpu_torch.train import (TrainConfig, create_train_state,
                                                  make_train_step)
    from animate_anything_tpu_torch.utils.convert import init_unet3d_, init_vae_

    dev = torch.device(device)
    axes = mesh_factors(dist.get_world_size())
    mesh = create_mesh(axes)
    data = axes["data"]
    unet = UNet3DConditionModel(nano_unet_config()).to(dev)
    init_unet3d_(unet, torch.Generator(dev).manual_seed(2))
    shard_model(unet, mesh)
    b, f, hw = max(2, 2 * data), 4, 16
    host = torch.Generator().manual_seed(0)
    batch = {"latents": torch.randn((b, f, hw // 8, hw // 8, 4), generator=host),
             "mask": torch.full((b, hw, hw), 255.0),
             "encoder_hidden_states": torch.randn((b, 7, 32), generator=host),
             "uncond_hidden_states": torch.zeros((b, 7, 32))}
    tconf = TrainConfig(motion_mask=True, motion_strength=True, cache_latents=True)
    state = create_train_state(unet, tconf, mesh=mesh, min_shard_size=0)   # as JAX's dry run
    step = make_train_step(make_schedule(), tconf, device=dev, mesh=mesh)
    metrics = step(state, shard_batch(batch, mesh), torch.Generator(dev).manual_seed(3))
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"dryrun loss is not finite: {metrics}")

    vae = AutoencoderKL(VAEConfig.tiny()).to(dev)
    init_vae_(vae, torch.Generator(dev).manual_seed(4))
    pipe = LatentToVideoPipeline(unet.eval(), vae, schedule=make_schedule(), mesh=mesh)
    bi, f_inf, hw_lat = max(2, data), 4, 8
    gen = torch.Generator(dev).manual_seed(5)
    img_latent = torch.randn((bi, 1, hw_lat, hw_lat, 4), generator=gen, device=dev)
    ts = pipe.get_timesteps(2)
    init = pipe.prepare_init_latents(img_latent, f_inf, ts, gen)
    embeds = torch.zeros((bi, 7, 32), device=dev)
    video, _ = pipe(latents=init, prompt_embeds=embeds, negative_prompt_embeds=embeds,
                    condition_latent=img_latent,
                    mask=torch.ones((bi, 1, hw_lat, hw_lat, 1), device=dev),
                    motion=[3.0] * bi, timesteps=ts)
    if not bool(torch.isfinite(video).all()):
        raise AssertionError("dryrun inference produced a non-finite video")
    if is_main_process():
        with open(out_path, "w") as fh:
            json.dump({"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                       "video": list(video.shape), "mesh": axes,
                       "optimizer_bytes": state.optimizer.state_bytes()}, fh)


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """One ZeRO-sharded train step and one sharded 2-step request on
    ``n_devices`` ranks of JAX's mesh (``mesh_factors``); → rank 0's {loss,
    grad_norm, video shape, mesh, optimizer bytes}."""
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        out = os.path.join(tmp, "result.json")
        spawn_ranks("animate_anything_tpu_torch.dryrun:_dryrun_rank", n_devices, device,
                    device, out, timeout=timeout)
        with open(out) as fh:
            result = json.load(fh)
    m = result["mesh"]
    print(f"dryrun mesh: data={m['data']} frame={m['frame']} tensor={m['tensor']}")
    print(f"dryrun_multichip({n_devices}) ok: loss={result['loss']:.4f}")
    print(f"dryrun_multichip({n_devices}) inference ok: video={tuple(result['video'])}")
    return result


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)
