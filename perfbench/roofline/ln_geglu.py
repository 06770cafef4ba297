"""Kernel 2's function, ``ops/geglu.py::ln_geglu_ff``: x + W2·(val ·
GELU(gate)) + b2 with [val ‖ gate] = W1·LayerNorm(x) + b1, over (n, c) rows.

Frozen copies, from commit f4aae42 of the repository:
- the FLOP and byte count of a call, ``chip_smoke.py::check_sites`` (kernel
  2's ``_add_site``): 24·n·c² FLOP (the (c → 8c) and (4c → c) products);
  bytes 2·n·c·2 (x in, y out, bf16) + 12·c²·2 (W1 and W2) + (8c + 3c)·4
  (b1, the LayerNorm affine and b2, fp32);
- the sites of one CFG forward, ``utils/kernel_sites.py`` (``SVD_GEGLU_SITES``)
  and PERF.md's kernel table (the mask + motion UNet's 33 calls a forward).

``CALLERS``: the program's modules that call the function, by the name
under which they hold it; the traced run wraps it there.
"""

from perfbench.roofline.peaks import bound_s as _bound

CALLERS = (("animate_anything_tpu_torch.models.attention", "ln_geglu_ff"),)

# (n rows, c, calls) of one CFG forward (b = 2): the mask + motion UNet at
# 64×64 latents and 17 frames (b·f = 34; transformer_in's c = 512 tail, ten
# spatial and ten temporal transformers at each of three levels, two mid),
# and the SVD UNet at 14 frames (b·f = 28).
SITES = {
    "animate_anything_512": ((34 * 4096, 512, 1), (34 * 4096, 320, 10), (34 * 1024, 640, 10),
                             (34 * 256, 1280, 10), (34 * 64, 1280, 2)),
    "svd_img2vid_mask": ((28 * 4096, 320, 15), (28 * 1024, 640, 15), (28 * 256, 1280, 15),
                         (28 * 64, 1280, 3)),
}


def flop_bytes(n: int, c: int) -> tuple[float, float]:
    return 24.0 * n * c * c, 2 * n * c * 2 + 12 * c * c * 2 + (8 * c + 3 * c) * 4


def bound_s(x, *args, **kw) -> float:
    """The least seconds of one call, from its input's shape."""
    c = x.shape[-1]
    return _bound(*flop_bytes(x.numel() // c, c))


def forward_bound_s(config: str) -> float:
    return sum(calls * _bound(*flop_bytes(n, c)) for n, c, calls in SITES[config])
