"""The kernel sites of one CFG forward of the full-width SVD UNet under
``attn_impl="pallas"`` (b = 2, 14 frames, 64×64 latents, 9 channels),
counted by running that forward on the meta device, where nothing is
computed or allocated, through the kernels' wrappers with the launches
recorded instead of made (as ``test_torch_port_sums_plans.py`` counts
kernel 6's sites; kernel 9's gate, which asks for a CUDA tensor, takes the
meta tensors for CUDA ones): kernel 1 15 calls, kernel 2 48, kernel 3 44 (stage 2
with the residual), kernel 5 16, and no other kernel, at exactly the shapes
of ``utils/kernel_sites.py``'s ``SVD_*_SITES``. Under ``"xla"`` the same
forward launches none; under ``"packed"`` kernel 9 only.
"""

import collections

import pytest
import torch

from test_torch_port_helpers import one_thread  # noqa: F401 (autouse fixture)

from animate_anything_tpu_torch.utils.kernel_sites import (SVD_BF, SVD_BLOCK_SITES,
                                                           SVD_FLASH_SITES, SVD_FRAMES,
                                                           SVD_GEGLU_SITES, SVD_TAP_SITES)

COUNTERS = ("flash_attention", "geglu", "temporal_conv", "temporal_block", "proj_residual",
            "group_norm", "streaming_group_norm", "spatial_conv", "temporal_attention",
            "add_stats", "ln_qkv_attention")


def _meta_forward(attn_impl):
    """→ (output shape, {kernel: Counter of recorded shapes}, {module: launches})."""
    import importlib

    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.ops import cuda_lib, flash_attention, geglu, temporal_block
    from animate_anything_tpu_torch.ops import temporal_attention, temporal_conv

    mods = {name: importlib.import_module(f"animate_anything_tpu_torch.ops.{name}")
            for name in COUNTERS}
    shapes = collections.defaultdict(collections.Counter)

    def recorder(kernel, fn, key):
        def record(*args, **kw):
            shapes[kernel][key(*args)] += 1
            return fn(*args, **kw)
        return record

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_lib, "call", lambda name, *args: None)
        mp.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
        mp.setattr(cuda_lib, "sm_count", lambda device: 132)
        for mod in mods.values():
            for attr in ("launches", "bwd_launches"):
                if hasattr(mod, attr):
                    mp.setattr(mod, attr, 0)
        mp.setattr(flash_attention, "flash_forward_with_lse", recorder(
            "flash", flash_attention.flash_forward_with_lse, lambda q, k, v, *a: tuple(q.shape)))
        mp.setattr(geglu, "_launch", recorder("geglu", geglu._launch,
                                              lambda x2, *a: tuple(x2.shape)))
        mp.setattr(temporal_conv, "_launch", recorder(
            "tap_conv", temporal_conv._launch,
            lambda x, a, b, w, bias, res: (tuple(x.shape), w.shape[0], res is not None)))
        mp.setattr(temporal_block, "_launch", recorder(
            "temporal_block", temporal_block._launch,
            lambda x, *a: (tuple(x.shape), a[-2])))
        # kernel 9's gate asks for a CUDA tensor: a meta one stands for it here
        gate = temporal_attention.packed_ok
        mp.setattr(temporal_attention, "packed_ok", lambda shape, impl, on_cuda: gate(
            shape, impl, True))
        mp.setattr(temporal_attention, "_launch", recorder(
            "temporal_attention", temporal_attention._launch, lambda q, *a: tuple(q.shape)))
        with torch.device("meta"):
            unet = UNetSpatioTemporalConditionModel(SVDUNetConfig(in_channels=9,
                                                                  attn_impl=attn_impl))
            unet = unet.to(torch.bfloat16)
            args = (torch.empty(2, SVD_FRAMES, 64, 64, 9, dtype=torch.bfloat16),
                    torch.tensor(0.25 * 3.1), torch.empty(2, 1, 1024, dtype=torch.bfloat16),
                    torch.empty(2, 3))
        with torch.no_grad():
            out = unet(*args)
        launches = {name: mod.launches for name, mod in mods.items()}
    return tuple(out.shape), shapes, launches


def test_svd_pallas_forward_runs_kernels_1_2_3_5_at_their_sites():
    shape, shapes, launches = _meta_forward("pallas")
    assert shape == (2, SVD_FRAMES, 64, 64, 4)
    assert shapes["flash"] == {(SVD_BF, s, h, 64): k for s, h, k in SVD_FLASH_SITES}
    assert shapes["geglu"] == {(n, c): k for n, c, k in SVD_GEGLU_SITES}
    # stage 1 without, stage 2 with the residual, half the calls each
    assert shapes["tap_conv"] == {((2, SVD_FRAMES, s, c), c, res): k // 2
                                  for s, c, k in SVD_TAP_SITES for res in (False, True)}
    assert shapes["temporal_block"] == {((2, SVD_FRAMES, s, c), h): k
                                        for s, c, h, k in SVD_BLOCK_SITES}
    assert "temporal_attention" not in shapes
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention=15, geglu=48, temporal_conv=44, temporal_block=16)
    assert launches == want


@pytest.mark.parametrize("attn_impl", ["xla", "packed"])
def test_svd_composite_forwards_launch_no_kernel_but_kernel_9(attn_impl):
    shape, shapes, launches = _meta_forward(attn_impl)
    assert shape == (2, SVD_FRAMES, 64, 64, 4)
    nine = sum(k for s, c, h, k in SVD_BLOCK_SITES) if attn_impl == "packed" else 0
    want = dict.fromkeys(COUNTERS, 0)
    want["temporal_attention"] = nine
    assert launches == want
