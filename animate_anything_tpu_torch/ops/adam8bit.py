"""Blockwise 8-bit AdamW — the port of ``animate_anything_tpu/ops/adam8bit.py``.

The Adam moments are stored quantized to 8 bits with one fp32 scale per
block of 256 elements of the flattened parameter: m (signed) as int8
symmetric (scale max|m|/127), v (non-negative) as uint8 (scale max v/255),
about 2.03 bytes a parameter against AdamW's 8. An update dequantizes one
parameter's moments, does the Adam math in fp32 in the blocked
(nblocks, 256) domain, writes the update and requantizes, so the fp32
moments exist for one parameter at a time, never whole. Plain torch, as
JAX's is plain ``jnp``: the update is memory-bound elementwise work.

``AdamW8bit`` keeps ``train/trainer.AdamW``'s interface (the trainable fp32
masters updated in place, clipping by global norm before it, ``MultiSteps``
accumulation, the ZeRO plan's slices: 256-aligned, so a rank holds whole
blocks and their scales) and JAX's rounding: the bias corrections 1 − βⁿ in
fp32, round half to even.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from animate_anything_tpu_torch.train.trainer import AdamW, accumulate, clip_factor

BLOCK = 256


def nblocks(size: int, block: int = BLOCK) -> int:
    return -(-size // block)


def blocked(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """A tensor → (nblocks, block) fp32, zero-padded."""
    flat = x.reshape(-1).float()
    n = nblocks(flat.numel(), block)
    return F.pad(flat, (0, n * block - flat.numel())).view(n, block)


def unblocked(b: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    size = 1
    for d in shape:
        size *= d
    return b.reshape(-1)[:size].reshape(shape).to(dtype)


def quantize(b: torch.Tensor, signed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nblocks, block) fp32 → (q, scale): int8 in [-127, 127] by max|x|/127
    when ``signed``, else uint8 in [0, 255] by max x/255; an all-zero block
    gets scale 0 and q 0."""
    if signed:
        scale = b.abs().amax(dim=1) / 127.0
        lo, hi, dt = -127, 127, torch.int8
    else:
        scale = b.amax(dim=1) / 255.0
        lo, hi, dt = 0, 255, torch.uint8
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(b / safe[:, None]), lo, hi).to(dt), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q, scale) → (nblocks, block) fp32."""
    return blocked(q) * scale[:, None]


class AdamW8bit(AdamW):
    """AdamW with int8/uint8 blockwise-quantized moments on the trainable fp32
    masters; ``trainer.make_optimizer`` routes ``use_8bit_adam`` here. The
    clipping, ``MultiSteps``, the state's save and load and the update's
    formula are ``AdamW``'s."""

    STATE = ("m_q", "m_scale", "v_q", "v_scale")
    BLOCK_STATE = ("m_scale", "v_scale")

    def _init_moments(self, masters: Dict[str, torch.Tensor]) -> None:
        own = {n: self.own(p, n) for n, p in masters.items()}
        self.m_q = {n: torch.zeros(p.shape, dtype=torch.int8, device=p.device)
                    for n, p in own.items()}
        self.v_q = {n: torch.zeros(p.shape, dtype=torch.uint8, device=p.device)
                    for n, p in own.items()}
        self.m_scale = {n: torch.zeros(nblocks(p.numel()), device=p.device)
                        for n, p in own.items()}
        self.v_scale = {n: torch.zeros(nblocks(p.numel()), device=p.device)
                        for n, p in own.items()}

    def _bias_corrections(self) -> Tuple[float, float]:
        """1 − β₁ⁿ and 1 − β₂ⁿ in fp32, as JAX computes them."""
        b1 = torch.tensor(self.config.adam_beta1, dtype=torch.float32)
        b2 = torch.tensor(self.config.adam_beta2, dtype=torch.float32)
        n = torch.tensor(float(self.count), dtype=torch.float32)
        return float(1.0 - b1 ** n), float(1.0 - b2 ** n)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], masters: Dict[str, torch.Tensor]) -> bool:
        cfg = self.config
        grads = accumulate(self, grads, masters)
        if grads is None:
            return False
        clip = clip_factor(grads, cfg.max_grad_norm, self.plan, self.tp, self.tp_names)
        self.count += 1
        c1, c2 = self._bias_corrections()
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        for n in self.names:
            p = self.own(masters[n], n)
            g = blocked(grads[n])
            if clip != 1.0:
                g = g * clip
            m = dequantize(self.m_q[n], self.m_scale[n])
            v = dequantize(self.v_q[n], self.v_scale[n])
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g.square()
            u = m / c1 / ((v / c2).sqrt() + cfg.adam_eps) + cfg.adam_weight_decay * blocked(p)
            p.add_(unblocked(-cfg.learning_rate * u, p.shape, p.dtype))
            mq, ms = quantize(m, signed=True)
            vq, vs = quantize(v, signed=False)
            self.m_q[n].copy_(unblocked(mq, p.shape, torch.int8))
            self.v_q[n].copy_(unblocked(vq, p.shape, torch.uint8))
            self.m_scale[n].copy_(ms)
            self.v_scale[n].copy_(vs)
        self._finish(masters)
        return True
