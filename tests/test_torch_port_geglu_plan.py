"""Kernel 2's launch plan (``ops/geglu.py::launch_plan``), on the CPU.

The wrapper picks the two GEMMs' tiles, ring depths, persistent grids and
shared-memory bytes without the card; these tests hold that plan to what
the kernels in ``csrc/geglu.cu`` take, at every main-path shape (the UNet's
temporal sites at 34 frames x locations) and at the JAX package's test
shapes of ``ops/geglu.py``, and at widths the kernel takes zero-padded to
a multiple of 8. Kernel 2's gate ``kernel_ok`` is pinned against the plan
case by case, beside JAX's routing (fused / wide kernel / lean composite)
at the same widths; the padding is held to JAX's ``_reference_lean``, and
so is ``ln_geglu_twin``, what the port runs on the card past the kernel's
reach and differentiates.
"""

import math
import re

import pytest

# (n rows, c): the main path's five, then JAX's test shapes (tests/test_ops.py
# and the port's parity tests: c = 128 over 40 rows, 64 over 24, 256 over 272),
# then widths off 16 (600, 8, 24), off 8 (100, 36: padded) and past 1280 up
# to MAX_C.
SHAPES = [(34 * 4096, 320), (34 * 4096, 512), (34 * 1024, 640), (34 * 256, 1280),
          (34 * 64, 1280), (40, 128), (24, 64), (272, 256), (5, 16), (300, 48),
          (300, 600), (64, 8), (64, 24), (300, 100), (9, 36), (300, 1536), (300, 2048),
          (300, 2432), (40, 4096)]


@pytest.mark.parametrize("n,c", SHAPES)
def test_plan_fits_the_card_and_the_kernel(n, c):
    from animate_anything_tpu_torch.ops import geglu

    plan = geglu.launch_plan(n, c, sms=132)
    cp = plan["cp"]
    assert cp % 8 == 0 and c <= cp < c + 8 and cp <= geglu.MAX_C
    for g in ("1", "2"):
        bn, stages, smem = plan["bn" + g], plan["stages" + g], plan["smem" + g]
        out = bn // 2 if g == "1" else bn
        # the ring: two or more stages of A (128 x 64) and B (bn x 64) bf16
        # tiles and their two mbarriers, past a 1024-byte alignment pad; then
        # the two warpgroups' 64 x out bf16 output tiles and two mbarriers
        assert 2 <= stages <= geglu.MAX_STAGES
        assert smem == 1024 + stages * (2 * 64 * (128 + bn) + 16) + 2 * 64 * out * 2 + 16
        assert smem <= 232448
        assert out % 32 == 0   # output chunks of 64 and 32 columns
        assert 1 <= plan["grid" + g] <= min(132, plan["tiles" + g])
    assert plan["bn1"] in geglu.GEGLU_BN and plan["bn2"] in geglu.OUT_BN
    # GEMM 2's tiles cover the cp output columns, GEMM 1's the 4cp act columns
    assert plan["tiles2"] == -(-n // 128) * -(-cp // plan["bn2"])
    assert plan["tiles1"] == -(-n // 128) * -(-4 * cp // (plan["bn1"] // 2))
    if (4 * cp) % 128 == 0:   # full tiles: the widest
        assert plan["bn1"] == 256


@pytest.mark.parametrize("n,c", SHAPES)
def test_plan_pairs_each_val_column_with_its_gate_column(n, c):
    """A GEMM 1 tile reads val rows [j, j + bn1/2) of W1 and gate rows
    [gate_row0 + j, ...): act column j meets gate column 4cp + j (W1 row
    4cp + j, diffusers' ``chunk(2)`` of the padded (8cp,) projection). A
    last tile past 4cp reads gate rows as val rows only for act columns it
    does not store."""
    from animate_anything_tpu_torch.ops import geglu

    plan = geglu.launch_plan(n, c)
    half, inner = plan["bn1"] // 2, 4 * plan["cp"]
    assert plan["gate_row0"] == inner
    for tile in range(plan["tiles1"] // -(-n // 128)):
        stored = range(tile * half, min(tile * half + half, inner))
        assert len(stored) > 0
        for j in stored:
            assert j < inner <= plan["gate_row0"] + j < 2 * inner
    assert (plan["tiles1"] // -(-n // 128)) * half < inner + half


@pytest.mark.parametrize("c", [0, -16, 4104, 4608, 8192])
def test_plan_refuses_widths_the_kernel_does_not_take(c):
    from animate_anything_tpu_torch.ops import geglu

    with pytest.raises(ValueError):
        geglu.launch_plan(64, c)


def test_plan_matches_the_kernel_instantiations():
    """The tile widths the plan may pick are the ones the C entry point
    dispatches on, and its shared-memory formula is the source's (the GEMM
    lives in ``gemm.cuh``, which kernel 5 shares)."""
    from animate_anything_tpu_torch.ops import cuda_lib, geglu

    text = (cuda_lib.CSRC / "geglu.cu").read_text() + (cuda_lib.CSRC / "gemm.cuh").read_text()
    geglu_bn = {int(b) for b in re.findall(r"launch_gemm<(\d+), true\b", text)}
    out_bn = {int(b) for b in re.findall(r"launch_gemm<(\d+), false\b", text)}
    assert geglu_bn == set(geglu.GEGLU_BN) and out_bn == set(geglu.OUT_BN)
    assert "return 1024 + stages * (STAGE_BYTES + 16) + 2 * OUT_BYTES + 16;" in text
    assert re.search(r"constexpr int BM = 128, BK = 64;", text)
    assert "mma_sync" not in text and "wgmma_ss<BN>" in text
    assert f"c % 8 != 0 || c > {geglu.MAX_C} ||" in text   # the C entry's reach


# ---- kernel 2's gate -------------------------------------------------------------

# Widths about kernel 2's reach: the UNet's three, one not a multiple of 16,
# two past 1280 (JAX's wide kernel takes both), one not a multiple of 8, the
# widest JAX's wide kernel takes and the next 128-aligned width past it, and
# one past MAX_C.
GATE_WIDTHS = [320, 640, 1280, 600, 1536, 2048, 100, 2432, 2560, 4104]


@pytest.mark.parametrize("c", GATE_WIDTHS)
def test_kernel_ok_holds_exactly_where_the_plan_takes_the_width(c):
    from animate_anything_tpu_torch.ops import geglu

    assert geglu.kernel_ok(c) == (c != 4104)
    if geglu.kernel_ok(c):
        geglu.launch_plan(256, c)
    else:
        with pytest.raises(ValueError):
            geglu.launch_plan(256, c)


class _Shaped:
    """An array as JAX's ``ln_geglu_ff`` routes on it: shapes only."""

    def __init__(self, *shape):
        self.shape, self.dtype = tuple(shape), "bfloat16"

    def reshape(self, *shape):
        size = math.prod(self.shape)
        return _Shaped(*(size // -math.prod(shape) if x == -1 else x for x in shape))

    def astype(self, dtype):
        return self


class _Route(str):
    def reshape(self, *shape):
        return self


# JAX's route at each width under impl="pallas" on the TPU (ops/geglu.py
# ln_geglu_ff :309-365): its fused kernel at c ≤ 640, its wide kernel at
# 128-aligned c > 640 while its row block stays ≥ 128 (to c = 2432), the
# lean composite elsewhere.
JAX_ROUTES = {320: "fused", 640: "fused", 1280: "wide", 600: "fused", 1536: "wide",
              2048: "wide", 100: "fused", 2432: "wide", 2560: "lean", 4104: "lean"}


@pytest.mark.parametrize("c", GATE_WIDTHS)
def test_jax_routes_each_gate_width(c):
    """Pins the JAX package's routing at the gate's widths, with its platform
    check patched to a TPU: wherever JAX runs a kernel, the port's kernel 2
    takes the width; where the port runs ``ln_geglu_twin`` (past MAX_C),
    JAX runs its lean composite."""
    import types

    import jax

    from animate_anything_tpu.ops import geglu as jg
    from animate_anything_tpu_torch.ops import geglu

    class OnTpu:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def devices():
            return [types.SimpleNamespace(platform="tpu")]

    n = 256
    args = (_Shaped(n, c), _Shaped(c), _Shaped(c), _Shaped(c, 8 * c), _Shaped(8 * c),
            _Shaped(4 * c, c), _Shaped(c))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "jax", OnTpu())
        mp.setattr(jg, "_fused_p", lambda *a: _Route("fused"))
        mp.setattr(jg, "_fused_wide_p", lambda *a: _Route("wide"))
        mp.setattr(jg, "_reference_lean", lambda *a: _Route("lean"))
        mp.setattr(jg, "_reference", lambda *a: _Route("exact"))
        mp.delenv("AA_WIDE_FF", raising=False)
        route = jg.ln_geglu_ff(*args, impl="pallas")
    assert route == JAX_ROUTES[c]
    assert route == "lean" or geglu.kernel_ok(c)
    assert geglu.kernel_ok(c) or route == "lean"


@pytest.mark.parametrize("c", [600, 1536])
def test_lean_twin_matches_jax_reference_lean(c):
    """``ln_geglu_twin``, what the port runs on the card past kernel 2's
    reach and differentiates everywhere, against JAX's ``_reference_lean``
    in fp32 (the same products summed in another order)."""
    import numpy as np
    import torch

    from animate_anything_tpu.ops.geglu import _reference_lean
    from animate_anything_tpu_torch.ops.geglu import ln_geglu_twin

    r = np.random.default_rng(c)
    x = r.standard_normal((6, c)).astype(np.float32)
    s = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    b = (0.05 * r.standard_normal(c)).astype(np.float32)
    w1 = (r.standard_normal((c, 8 * c)) / np.sqrt(c)).astype(np.float32)   # JAX (in, out)
    b1 = (0.1 * r.standard_normal(8 * c)).astype(np.float32)
    w2 = (r.standard_normal((4 * c, c)) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (0.1 * r.standard_normal(c)).astype(np.float32)
    want = np.asarray(_reference_lean(x, s, b, w1, b1, w2, b2, 1e-5))
    t = torch.from_numpy
    got = ln_geglu_twin(t(x), t(s), t(b), t(np.ascontiguousarray(w1.T)), t(b1),
                        t(np.ascontiguousarray(w2.T)), t(b2), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("c", [100, 36, 20, 1])
def test_padded_operands_compute_the_call(c):
    """Kernel 2's arithmetic (LN statistics over the first c columns, both
    products with fp32 accumulation) on ``pad_operands``' width-cp operands
    gives JAX's ``_reference_lean`` in y's first c columns and zeros in the
    padded act and y columns, in fp32."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from animate_anything_tpu.ops.geglu import _reference_lean
    from animate_anything_tpu_torch.ops import geglu

    r = np.random.default_rng(c)
    x = r.standard_normal((6, c)).astype(np.float32)
    s = (1.0 + 0.1 * r.standard_normal(c)).astype(np.float32)
    b = (0.05 * r.standard_normal(c)).astype(np.float32)
    w1 = (r.standard_normal((c, 8 * c)) / np.sqrt(c)).astype(np.float32)   # JAX (in, out)
    b1 = (0.1 * r.standard_normal(8 * c)).astype(np.float32)
    w2 = (r.standard_normal((4 * c, c)) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (0.1 * r.standard_normal(c)).astype(np.float32)
    want = np.asarray(_reference_lean(x, s, b, w1, b1, w2, b2, 1e-5))

    cp = geglu.launch_plan(6, c)["cp"]
    assert cp % 8 == 0 and cp > c
    t = torch.from_numpy
    xp, sp, bp, w1p, b1p, w2p, b2p = geglu.pad_operands(
        t(x), t(s), t(b), t(np.ascontiguousarray(w1.T)), t(b1), t(np.ascontiguousarray(w2.T)),
        t(b2), cp)
    assert xp.shape == (6, cp) and w1p.shape == (8 * cp, cp) and w2p.shape == (cp, 4 * cp)
    xt = xp[:, :c]
    mu = xt.mean(-1, keepdim=True)
    var = (xt - mu).square().mean(-1, keepdim=True)   # over the first c columns only
    ln = (xp - mu) * torch.rsqrt(var + 1e-5) * sp + bp
    val, gate = (ln @ w1p.t() + b1p).chunk(2, dim=-1)
    act = val * F.gelu(gate, approximate="tanh")
    y = act @ w2p.t() + b2p + xp
    assert torch.all(ln[:, c:] == 0) and torch.all(act[:, 4 * c:] == 0)
    assert torch.all(y[:, c:] == 0)
    np.testing.assert_allclose(y[:, :c].numpy(), want, atol=1e-5)


@pytest.mark.parametrize("c,kernel", [(4104, False), (600, True), (320, True), (100, True)])
def test_ln_geglu_ff_off_the_cpu_takes_the_twin_past_the_reach(c, kernel):
    """A tensor off the CPU goes to kernel 2 wherever ``kernel_ok`` holds
    (the kernel's checks then refuse the meta tensor); past the reach it
    runs ``ln_geglu_twin`` and returns a tensor of x's shape."""
    import torch

    from animate_anything_tpu_torch.ops import geglu

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, device="meta", dtype=dtype)

    f32 = torch.float32
    args = (meta(2, 3, c), meta(c, dtype=f32), meta(c, dtype=f32), meta(8 * c, c),
            meta(8 * c, dtype=f32), meta(c, 4 * c), meta(c, dtype=f32))
    before = geglu.launches
    if kernel:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            geglu.ln_geglu_ff(*args)
    else:
        assert geglu.ln_geglu_ff(*args).shape == (2, 3, c)
    assert geglu.launches == before
