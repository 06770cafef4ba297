"""The frozen site tables of the roofline functions against the structure of
the plain reference: one CFG forward of each configuration's UNet at the
cells' full shapes on the meta device, its feed-forward tails and its
temporal-conv stages counted by shape."""

from collections import Counter

import pytest
import torch

from perfbench.harness import registry
from perfbench.reference.numerics import Numerics

CELLS = {"animate_anything_512": "a512.request", "svd_img2vid_mask": "svd.request"}


def _meta_forward(config: str):
    """Counts of (n, c) feed-forward calls and (b, f, s, c, residual)
    temporal-conv stages in one CFG forward on meta."""
    system = registry.config_module(config).System(registry.config(config), "cpu")
    spec = registry.workload(CELLS[config])
    traffic = registry.traffic(spec["traffic"])
    meta = {}
    for key, (shape, _) in system.shapes().items():
        comp, name = key.split(".", 1)
        meta.setdefault(comp, {})[name] = torch.empty(shape, device="meta")
    ref = registry.config_module(config).Request(meta, system.cfg, Numerics("fp32"))
    geglu, taps = Counter(), Counter()
    unet = ref.unet
    real_geglu = unet.geglu

    def count_geglu(x, key):
        geglu[(x.numel() // x.shape[-1], x.shape[-1])] += 1
        return real_geglu(x, key)

    unet.geglu = count_geglu
    res, f = traffic["resolution"] // 8, traffic["frames"]
    if config == "animate_anything_512":
        real_tc = unet.temporal_conv

        def count_tc(x, nf, key):
            b, s, c = x.shape[0] // nf, x.shape[1] * x.shape[2], x.shape[3]
            taps[(b, nf, s, c, False)] += 3
            taps[(b, nf, s, c, True)] += 1
            return real_tc(x, nf, key)

        unet.temporal_conv = count_tc
        x = torch.empty(1, f, res, res, 4, device="meta")
        c = {"text": torch.empty(2, 77, 1024, device="meta"),
             "cond": torch.empty(1, 1, res, res, 4, device="meta"),
             "mask": torch.empty(1, 1, res, res, 1, device="meta"),
             "motion": torch.empty(1, device="meta")}
        ref.forward(c, x, 500)
    else:
        real_stage = unet.tap_stage
        seen = Counter()

        def count_stage(h, key_norm, key_conv):
            b, nf, s, ch = h.shape
            seen[key_conv.rsplit(".", 2)[0]] += 1
            taps[(b, nf, s, ch, key_conv.endswith("conv2"))] += 1
            return real_stage(h, key_norm, key_conv)

        unet.tap_stage = count_stage
        x = torch.empty(2, f, res, res, 9, device="meta")
        unet(x, 0.5, torch.empty(2, 1, 1024, device="meta"),
             torch.empty(2, 3, device="meta"))
    return geglu, taps


@pytest.mark.parametrize("config", sorted(CELLS))
def test_site_tables_match_the_reference(config):
    geglu, taps = _meta_forward(config)
    want_geglu = Counter({(n, c): k for n, c, k in
                          registry.roofline_module("ln_geglu").SITES[config]})
    assert geglu == want_geglu
    want_taps = Counter()
    for b, f, s, c, calls, with_res in registry.roofline_module("tap_conv").SITES[config]:
        want_taps[(b, f, s, c, False)] += calls - with_res
        want_taps[(b, f, s, c, True)] += with_res
    assert taps == want_taps


def test_bounds_of_a_forward():
    """The frozen formulas at the tables' sites (H100 peaks): kernel 2's sites
    of a mask + motion forward are FLOP-bound."""
    geglu = registry.roofline_module("ln_geglu")
    n, c, _ = geglu.SITES["animate_anything_512"][1]
    flop, nbytes = geglu.flop_bytes(n, c)
    assert flop == 24.0 * n * c * c and flop / 989e12 > nbytes / 3.35e12
    assert geglu.forward_bound_s("animate_anything_512") == pytest.approx(
        sum(k * 24.0 * n * c * c / 989e12 for n, c, k in geglu.SITES["animate_anything_512"]))
    tap = registry.roofline_module("tap_conv")
    assert tap.forward_bound_s("svd_img2vid_mask") > 0
