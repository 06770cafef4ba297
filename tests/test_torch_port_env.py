"""Properties of the PyTorch port that need no JAX reference: it never
imports JAX, its smoke script refuses to run without a CUDA device, its
kernel wrappers (the flash backward's too) never fall back to the plain
version for a non-CPU tensor and always hand their outputs to autograd, and
its initialisers draw what the flax ones draw."""

import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_importing_the_whole_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import animate_anything_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'animate_anything_tpu'))\n"
        "assert len(names) >= 23, names\n"
        "assert {pkg.__name__ + '.' + m for m in ('ops.temporal_block', 'models.clip_text',\n"
        "        'models.clip_tokenizer', 'models.tokenizers', 'ops.autograd', 'train.trainer',\n"
        "        'metrics.motion', 'ops.group_norm', 'ops.streaming_group_norm',\n"
        "        'ops.spatial_conv', 'models.svd_unet', 'models.clip_vision', 'pipelines.svd',\n"
        "        'diffusion.euler_edm', 'cli_svd', 'train_svd')} <= set(names), names\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                       "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("op", ["flash", "flash_backward", "geglu", "tap_conv", "proj",
                                "temporal_block", "channel_sums", "group_norm_stream",
                                "spatial_conv"])
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(op):
    """A tensor that is not on the CPU goes to the kernel path, whose checks
    refuse anything but a CUDA tensor: there is no silent fallback."""
    from animate_anything_tpu_torch.ops import flash_attention, geglu, group_norm, \
        proj_residual, spatial_conv, streaming_group_norm, temporal_block, temporal_conv

    f32 = torch.float32
    calls = {
        "flash": lambda: flash_attention.flash_attention(*(_meta(1, 128, 2, 64),) * 3),
        "flash_backward": lambda: flash_attention.flash_attention_backward(
            *(_meta(1, 128, 2, 64),) * 5, lse=_meta(1, 2, 128, dtype=f32)),
        "geglu": lambda: geglu.ln_geglu_ff(_meta(4, 32), _meta(32, dtype=f32),
                                           _meta(32, dtype=f32), _meta(256, 32),
                                           _meta(256, dtype=f32), _meta(32, 128),
                                           _meta(32, dtype=f32)),
        "tap_conv": lambda: temporal_conv.tap_conv(_meta(1, 3, 4, 32), _meta(1, 32, dtype=f32),
                                                   _meta(1, 32, dtype=f32), _meta(32, 3, 32),
                                                   _meta(32, dtype=f32)),
        "proj": lambda: proj_residual.proj_residual_stats(_meta(2, 4, 16), _meta(8, 16),
                                                          _meta(8, dtype=f32), _meta(2, 4, 8)),
        "temporal_block": lambda: temporal_block.temporal_block(
            _meta(1, 4, 8, 64), _meta(64, dtype=f32), _meta(64, dtype=f32),
            *(_meta(64, 64),) * 4, _meta(64, dtype=f32), heads=2),
        "channel_sums": lambda: group_norm.stream_channel_sums(_meta(2, 16, 64)),
        "group_norm_stream": lambda: streaming_group_norm.group_norm_stream(
            _meta(2, 16, 128), _meta(128, dtype=f32), _meta(128, dtype=f32), 32),
        "spatial_conv": lambda: spatial_conv.spatial_conv(
            _meta(1, 4, 4, 32), _meta(1, 32, dtype=f32), _meta(1, 32, dtype=f32),
            _meta(8, 32, 3, 3), _meta(1, 8, dtype=f32), _meta(1, 4, 4, 8)),
    }
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        calls[op]()


def _cpu(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed),
                       requires_grad=True)


@pytest.mark.parametrize("op", ["flash", "geglu", "tap_conv", "proj", "temporal_block",
                                "channel_sums", "spatial_conv"])
def test_kernel_wrappers_carry_gradients_on_the_cpu(op):
    """Every wrapper's outputs hang off its autograd Function, on the CPU as
    on the card, and every input gets a gradient: a kernel output written
    through ``data_ptr()`` would have no ``grad_fn`` and leave every
    parameter upstream without one."""
    from animate_anything_tpu_torch.ops import flash_attention, geglu, group_norm, \
        proj_residual, spatial_conv, temporal_block, temporal_conv

    shapes = {
        "flash": [(1, 128, 2, 32)] * 3,
        "geglu": [(4, 32), (32,), (32,), (256, 32), (256,), (32, 128), (32,)],
        "tap_conv": [(1, 3, 4, 32), (1, 32), (1, 32), (32, 3, 32), (32,), (1, 3, 4, 32)],
        "proj": [(2, 4, 16), (8, 16), (8,), (2, 4, 8)],
        "temporal_block": [(1, 4, 8, 64), (64,), (64,)] + [(64, 64)] * 4 + [(64,)],
        "channel_sums": [(2, 16, 64)],
        "spatial_conv": [(1, 4, 4, 32), (1, 32), (1, 32), (8, 32, 3, 3), (1, 8), (1, 4, 4, 8)],
    }
    fns = {"flash": flash_attention.flash_attention, "geglu": geglu.ln_geglu_ff,
           "tap_conv": temporal_conv.tap_conv, "proj": proj_residual.proj_residual_stats,
           "temporal_block": lambda *a: temporal_block.temporal_block(*a, heads=2),
           "channel_sums": group_norm.stream_channel_sums,
           "spatial_conv": spatial_conv.spatial_conv}
    inputs = [_cpu(*shape, seed=i) for i, shape in enumerate(shapes[op])]
    out = fns[op](*inputs)
    leaves = ([out] if isinstance(out, torch.Tensor) else list(out) if op == "channel_sums"
              else [out[0], *out[1]])
    assert all(y.grad_fn is not None for y in leaves)
    sum(y.sum() for y in leaves).backward()
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in inputs)


def test_flash_backward_wrapper_takes_the_plain_version_for_cpu_tensors():
    from animate_anything_tpu_torch.ops import flash_attention as fa

    q, k, v, o, do = (_cpu(1, 128, 2, 32, seed=i).detach() for i in range(5))
    for got, want in zip(fa.flash_attention_backward(q, k, v, o, do),
                         fa.flash_attention_backward_reference(q, k, v, o, do)):
        assert torch.equal(got, want)


def test_kernel_sources_cover_every_entry_point():
    from animate_anything_tpu_torch.ops import cuda_lib

    text = "\n".join(p.read_text() for p in cuda_lib.sources())
    for name in cuda_lib._SIGNATURES:
        assert f"AAT_EXPORT int {name}(" in text
    assert cuda_lib.library_path().parent == REPO / "build" / "torch_kernels"


def test_flash_head_dims_match_the_kernel_instantiations():
    """The Python gate admits exactly the head sizes the C entry point
    instantiates, and the Hopper header is part of the build's hash."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import flash_attention as fa

    text = (cuda_lib.CSRC / "flash_attention.cu").read_text()
    cases = tuple(int(d) for d in re.findall(r"AAT_FLASH_CASE\((\d+)\)", text))
    assert cases == fa.HEAD_DIMS == tuple(range(16, 257, 16))
    assert set(fa.BWD_HEAD_DIMS) <= set(fa.HEAD_DIMS)
    assert '#include "hopper.cuh"' in text and cuda_lib.CSRC / "hopper.cuh" in cuda_lib.sources()


def test_flash_backward_head_dims_match_the_kernel_instantiations():
    """The backward's gate admits exactly the head sizes its C entry point
    instantiates: the forward's, every d % 16 == 0 from 16 to 256."""
    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import flash_attention as fa

    text = (cuda_lib.CSRC / "flash_attention_bwd.cu").read_text()
    cases = tuple(int(d) for d in re.findall(r"AAT_FLASH_BWD_CASE\((\d+)\)", text))
    assert cases == fa.BWD_HEAD_DIMS == fa.HEAD_DIMS
    assert '#include "hopper.cuh"' in text and "mma.sync" not in text


@pytest.mark.parametrize("source,replaces", [
    ("flash_attention.cu", "ops/flash_attention.py::_flash_forward"),
    ("geglu.cu", "ops/geglu.py::_pallas_ln_geglu"),
    ("temporal_conv.cu", "ops/temporal_conv.py::_pallas_stage"),
    ("proj_residual.cu", "ops/proj_residual.py::_pallas_proj"),
    ("temporal_block.cu", "ops/temporal_block.py::_build_bfsc"),
    ("flash_attention_bwd.cu", "ops/flash_attention.py::_flash_backward_lanes"),
    ("flash_attention_bwd.cu", "ops/flash_attention.py::_flash_backward"),
    ("group_norm.cu", "ops/group_norm.py::_pallas_channel_sums"),
    ("group_norm.cu", "ops/attic/streaming_group_norm.py::_pallas_group_norm"),
    ("spatial_conv.cu", "ops/attic/spatial_conv.py::_pallas_stage"),
    ("spatial_conv.cu", "ops/attic/conv3x3.py::_pallas_stage"),
])
def test_every_kernel_source_names_the_tpu_kernel_it_replaces(source, replaces):
    from animate_anything_tpu_torch.ops import cuda_lib

    path = cuda_lib.CSRC / source
    assert path in cuda_lib.sources()
    header = path.read_text().split("#include", 1)[0]
    assert "animate_anything_tpu/" + replaces in header.replace("\n// ", " ")


def test_init_matches_flax_initialisers():
    from animate_anything_tpu_torch.models import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    m = init_unet3d_(UNet3DConditionModel(UNet3DConfig.tiny(motion_mask=True,
                                                             motion_strength=True,
                                                             attn_impl="pallas")),
                     torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in m.named_parameters()}
    conv4 = [k for k in params if ".conv4.3." in k]
    assert conv4 and all(float(params[k].abs().max()) == 0.0 for k in conv4)
    assert all(float(p.abs().max()) == 0.0 for k, p in params.items() if k.endswith(".bias"))
    norms = [p for k, p in params.items() if p.ndim == 1 and k.endswith(".weight")]
    assert norms and all(bool((p == 1).all()) for p in norms)
    # lecun normal: std 1/sqrt(fan_in), truncated at 2/0.8796 of that
    w = params["down_blocks.1.resnets.0.conv1.weight"]           # (64, 32, 3, 3)
    fan_in = 32 * 9
    assert abs(float(w.std()) * math.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) * math.sqrt(fan_in) <= 2.0 / 0.87962566103423978 + 1e-6


def test_profiler_groups_kernels_and_times_a_call():
    from animate_anything_tpu_torch.utils.profiling import device_profile, kernel_group

    assert kernel_group("void flash_fwd_kernel<64>(Params)") == "flash_attention (kernel 1)"
    assert kernel_group("void flash_bwd_dkv_kernel<64, 64>(...)") == "flash_attention backward"
    assert kernel_group("void multi_tensor_apply_kernel<...>") == "optimizer (foreach)"
    assert kernel_group("void aat::(anonymous namespace)::channel_sums_kernel<false>(...)") \
        == "channel_sums (kernel 6)"
    assert kernel_group("void aat::(anonymous namespace)::gn_stream_kernel<true>(...)") \
        == "group_norm_stream (kernel 7)"
    assert kernel_group("void aat::lnqkv::ln_qkv_gemm_kernel<320>(...)") == "ln_qkv (kernel 11)"
    assert kernel_group("void spatial_conv_kernel(...)") == "spatial_conv (kernel 8)"
    assert kernel_group("sm90_xmma_fprop_implicit_gemm_bf16") == "conv (cuDNN)"
    assert kernel_group("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul (cuBLAS)"
    assert kernel_group("nvjet_tst_128x64_64x4") == "matmul (cuBLAS)"
    assert kernel_group("vectorized_elementwise_kernel<4, silu>") == "elementwise/other"
    prof = device_profile(lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert prof["wall_ms"] > 0 and len(prof["walls_ms"]) == 3
    assert prof["wall_ms"] == sorted(prof["walls_ms"])[1]
    assert prof["host_ms"] > 0 and any("mm" in op[2] for op in prof["host_ops"])
    assert prof["kernels"] == [] and prof["kernel_ms"] == 0   # no device on this host
    assert prof["idle_share"] == 1.0 and prof["spans"] == {}


def test_profiler_tables_the_ports_spans():
    """``device_profile`` reads the ``aat.*`` spans of the profiled call: the
    count, the device time launched inside (none here) and the idle time
    inside, which on a host without a device is each span's whole length."""
    from animate_anything_tpu_torch.utils.profiling import device_profile
    from animate_anything_tpu_torch.utils.tracing import span, traced

    @traced("op.matmul")
    def op():
        return torch.ones(64, 64) @ torch.ones(64, 64)

    def call():
        with span("step"):
            op()
            op()

    prof = device_profile(call)
    assert set(prof["spans"]) == {"aat.step", "aat.op.matmul"}
    step, ops = prof["spans"]["aat.step"], prof["spans"]["aat.op.matmul"]
    assert step["count"] == 1 and ops["count"] == 2
    assert step["device_ms"] == ops["device_ms"] == 0.0
    assert 0 < ops["idle_ms"] <= step["idle_ms"]
    # the ranges are not operations: neither the host's nor (on a card) the device's
    assert not [op for op in prof["host_ops"] if op[2].startswith("aat.") or "profile" in op[2]]


class _Event:
    """A kineto event of a synthetic trace (ms → ns)."""

    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self.v = (name, "DeviceType." + device, int(start * 1e6), int((end - start) * 1e6),
                  corr, annotation)

    def name(self):
        return self.v[0]

    def device_type(self):
        return self.v[1]

    def start_ns(self):
        return self.v[2]

    def duration_ns(self):
        return self.v[3]

    def correlation_id(self):
        return self.v[4]

    def is_user_annotation(self):
        return self.v[5]


def test_trace_spans_on_a_synthetic_trace():
    """A 100 ms call, the device busy over [10, 50) and [60, 90) ms; a UNet
    span [5, 55) holding two wrapper spans [6, 8) and [20, 22) that launch
    a 20 ms and a 15 ms kernel; a third kernel launched outside them."""
    from animate_anything_tpu_torch.utils.profiling import CALL, trace_spans

    ev = [_Event(CALL, "CPU", 0, 100, annotation=True),
          _Event("aat.unet", "CPU", 5, 55, annotation=True),
          _Event("aat.op.k", "CPU", 6, 8, annotation=True),
          _Event("aat.op.k", "CPU", 20, 22, annotation=True),
          _Event("cudaLaunchKernel", "CPU", 7, 7.01, corr=1),
          _Event("cudaLaunchKernel", "CPU", 21, 21.01, corr=2),
          _Event("cudaLaunchKernel", "CPU", 58, 58.01, corr=3),
          _Event("aten::mm", "CPU", 21, 21.5, corr=4),
          _Event("k1", "CUDA", 10, 30, corr=1),
          _Event("k2", "CUDA", 35, 50, corr=2),
          _Event("k3", "CUDA", 60, 90, corr=3),
          _Event("aat.unet", "CUDA", 10, 50, annotation=True)]
    out = trace_spans(ev)
    assert out["idle_share"] == pytest.approx(0.35)     # idle [0,10) [30,35) [50,60) [90,100)
    unet, ops = out["spans"]["aat.unet"], out["spans"]["aat.op.k"]
    assert unet["count"] == 1 and ops["count"] == 2
    assert unet["device_ms"] == pytest.approx(35.0) and ops["device_ms"] == pytest.approx(35.0)
    assert unet["idle_ms"] == pytest.approx(15.0)      # [5,10), [30,35), [50,55)
    assert ops["idle_ms"] == pytest.approx(2.0)        # [6,8); [20,22) is busy
    assert trace_spans(ev[1:])["idle_share"] is None    # no call range
