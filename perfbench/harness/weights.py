"""Weights drawn on the card from the seed, in a few large calls, in the
dtypes they are served in: a matrix or kernel is lecun-normal
(N(0, 1/fan_in), fan_in its elements per output row), a norm scale
1 + N(0, 0.1²), any other vector N(0, 0.02²). The same seed gives the same
state dict, which the program loads and the reference reads."""

from __future__ import annotations

import torch


def draw(shapes: dict, seed: int, device) -> dict:
    """``shapes``: name → (shape, dtype) → name → tensor, views of one buffer
    a dtype."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    by_dtype: dict = {}
    for name, (shape, dtype) in shapes.items():
        by_dtype.setdefault(dtype, []).append((name, tuple(shape)))
    for dtype in sorted(by_dtype, key=str):
        entries = by_dtype[dtype]
        total = sum(_numel(s) for _, s in entries)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        at = 0
        for name, shape in entries:
            n = _numel(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if len(shape) >= 2:
                t.mul_(float(n // shape[0]) ** -0.5)
            elif name.endswith("weight"):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02)
            out[name] = t
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()
            if v.is_floating_point()}


def as_fp32(state: dict) -> dict:
    return {k: v.float() for k, v in state.items()}


def split(flat: dict, components) -> dict:
    """``"<component>.<key>"`` → component → key → tensor."""
    out = {c: {} for c in components}
    for key, t in flat.items():
        comp, name = key.split(".", 1)
        out[comp][name] = t
    return out


def meta(shapes: dict, components) -> dict:
    """Empty float32 tensors of the shapes on the meta device, by component."""
    return split({k: torch.empty(s, device="meta") for k, (s, _) in shapes.items()}, components)
