"""Kernel 3's function, ``ops/temporal_conv.py::gn_silu_tap_conv``: one
temporal-conv stage, GroupNorm → SiLU → 3-tap frame conv (zero frames past
the ends) → + residual, on (b, f, s, c).

Frozen copies, from commit f4aae42 of the repository:
- the FLOP and byte count of a call, ``chip_smoke.py::check_sites``
  (kernel 3's ``_add_site``): 2·b·s·(3f − 2)·c_in·c_out FLOP (the taps that
  land inside the clip); bytes (2 + r)·b·f·s·c·2 (x in, y out, the residual
  r ∈ {0, 1} in, bf16) + 3·c_in·c_out·2 (the taps) + 2·b·f·c·4 (the fp32
  Σ / Σ² of the output);
- the sites of one CFG forward, ``utils/kernel_sites.py``
  (``TAP_CONV_SITES``: four stages a layer, the last with the residual;
  ``SVD_TAP_SITES``).
"""

from perfbench.roofline.peaks import bound_s as _bound

CALLERS = (("animate_anything_tpu_torch.models.layers", "gn_silu_tap_conv"),
           ("animate_anything_tpu_torch.models.svd_unet", "gn_silu_tap_conv"))

# (b, f, s, c, calls, calls with the residual) of one CFG forward: 22
# temporal-conv layers of the mask + motion UNet (4 stages each) at 17
# frames; the SVD UNet's 22 temporal resnets (2 stages each, the second
# with the residual) at 14 frames.
SITES = {
    "animate_anything_512": ((2, 17, 4096, 320, 20, 5), (2, 17, 1024, 640, 20, 5),
                             (2, 17, 256, 1280, 20, 5), (2, 17, 64, 1280, 28, 7)),
    "svd_img2vid_mask": ((2, 14, 4096, 320, 10, 5), (2, 14, 1024, 640, 10, 5),
                         (2, 14, 256, 1280, 10, 5), (2, 14, 64, 1280, 14, 7)),
}


def flop_bytes(b: int, f: int, s: int, cin: int, cout: int, residual: bool):
    flop = 2.0 * b * s * (3 * f - 2) * cin * cout
    nbytes = (2 + int(residual)) * b * f * s * cout * 2 + 3 * cin * cout * 2 + 2 * b * f * cout * 4
    return flop, nbytes


def bound_s(x, gn_scale, gn_bias, w, *args, residual=None, **kw) -> float:
    b, f, s, cin = x.shape
    return _bound(*flop_bytes(b, f, s, cin, w.shape[0], residual is not None))


def forward_bound_s(config: str) -> float:
    total = 0.0
    for b, f, s, c, calls, with_res in SITES[config]:
        total += (calls - with_res) * _bound(*flop_bytes(b, f, s, c, c, False))
        total += with_res * _bound(*flop_bytes(b, f, s, c, c, True))
    return total
