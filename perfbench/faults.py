"""The faults that each kind of cell can have, planted under the timed path:
``plant(kind, name, program)`` breaks the built program (or train state)
and returns an undo. The check must come out not correct under each: the
CPU tests plant them at a small size; ``calibrate.py --faults`` reads the
training cell's numbers under them at its own size on the card."""

from __future__ import annotations

import torch

REQUEST_FAULTS = ("unchanged_step", "half_batch", "altered_answer")
TRAIN_FAULTS = ("unchanged_state", "half_batch", "altered_answer", "reversed_update")


def _swap(owner, attr, new):
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    return lambda: setattr(owner, attr, old)


def _half_unet(unet):
    """The UNet on the second half of the CFG batch only, its output given
    for both halves (the mean over the rest)."""
    forward = unet.forward

    def half(sample, *args, **kw):
        b = sample.shape[0] // 2
        args = [a[b:] if torch.is_tensor(a) and a.dim() and a.shape[0] == 2 * b else a
                for a in args]
        out = forward(sample[b:], *args, **kw)
        return torch.cat([out, out])

    unet.forward = half
    return lambda: unet.__dict__.pop("forward", None)


def plant(kind: str, name: str, program):
    """``kind``: ``"a512"``, ``"svd"`` or ``"train"``."""
    if kind == "train":
        import animate_anything_tpu_torch.train.trainer as tr

        if name == "unchanged_state":
            def no_update(state):
                for p in state.model.parameters():
                    p.grad = None
                state.step += 1
                return 0.0

            return _swap(tr, "apply_gradients", no_update)
        if name == "half_batch":
            step = program["step"]

            def half(state, batch, generator):
                b = batch["pixel_values"].shape[0] // 2
                return step(state, {k: v[b:] for k, v in batch.items()}, generator)

            return _swap_item(program, "step", half)
        if name == "altered_answer":
            apply = tr.apply_gradients

            def altered(state):
                p = next(iter(state.model.parameters()))
                p.grad = p.grad * 2
                return apply(state)

            return _swap(tr, "apply_gradients", altered)
        if name == "reversed_update":   # every step of the right size, uphill
            apply = tr.apply_gradients

            def reversed_(state):
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad = -p.grad
                return apply(state)

            return _swap(tr, "apply_gradients", reversed_)
        raise ValueError(name)
    if kind == "a512":
        import animate_anything_tpu_torch.diffusion.samplers as samplers
        import animate_anything_tpu_torch.pipelines.latent2video as pipe
        step_owner, step_attr = samplers, "dpmpp_step"
        unchanged = lambda schedule, tables, state, out, i: state  # noqa: E731
    elif kind == "svd":
        import animate_anything_tpu_torch.pipelines.svd as pipe
        step_owner, step_attr = pipe, "euler_step"
        unchanged = lambda sample, *a, **k: sample  # noqa: E731
    else:
        raise ValueError(kind)
    if name == "unchanged_step":
        return _swap(step_owner, step_attr, unchanged)
    if name == "half_batch":
        return _half_unet(program.unet)
    if name == "altered_answer":
        decode = pipe.decode_video

        def altered(vae, latents, chunk_size=None):
            video = decode(vae, latents, chunk_size)
            video[:, 0] = -video[:, 0]
            return video

        return _swap(pipe, "decode_video", altered)
    raise ValueError(name)


def _swap_item(d: dict, key, new):
    old = d[key]
    d[key] = new
    return lambda: d.__setitem__(key, old)
