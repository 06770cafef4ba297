"""Kernel 2's launch plan (``ops/geglu.py::launch_plan``), on the CPU.

The wrapper picks the two GEMMs' tiles, ring depths, persistent grids and
shared-memory bytes without the card; these tests hold that plan to what
the kernels in ``csrc/geglu.cu`` take, at every main-path shape (the UNet's
temporal sites at 34 frames x locations) and at the JAX package's test
shapes of ``ops/geglu.py``.
"""

import re

import pytest

# (n rows, c): the main path's five, then JAX's test shapes (tests/test_ops.py
# and the port's parity tests: c = 128 over 40 rows, 64 over 24, 256 over 272).
SHAPES = [(34 * 4096, 320), (34 * 4096, 512), (34 * 1024, 640), (34 * 256, 1280),
          (34 * 64, 1280), (40, 128), (24, 64), (272, 256), (5, 16), (300, 48)]


@pytest.mark.parametrize("n,c", SHAPES)
def test_plan_fits_the_card_and_the_kernel(n, c):
    from animate_anything_tpu_torch.ops import geglu

    plan = geglu.launch_plan(n, c, sms=132)
    assert c % 16 == 0 and c <= geglu.MAX_C
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
    # GEMM 2's tiles cover the c output columns, GEMM 1's the 4c act columns
    assert plan["tiles2"] == -(-n // 128) * -(-c // plan["bn2"])
    assert plan["tiles1"] * (plan["bn1"] // 2) == -(-n // 128) * 4 * c


@pytest.mark.parametrize("n,c", SHAPES)
def test_plan_pairs_each_val_column_with_its_gate_column(n, c):
    """A GEMM 1 tile reads val rows [j, j + bn1/2) of W1 and gate rows
    [gate_row0 + j, ...): act column j meets gate column 4c + j (W1 row
    4c + j, diffusers' ``chunk(2)`` of the (8c,) projection)."""
    from animate_anything_tpu_torch.ops import geglu

    plan = geglu.launch_plan(n, c)
    half = plan["bn1"] // 2
    assert plan["gate_row0"] == 4 * c
    assert (4 * c) % half == 0   # no tile straddles the val/gate boundary
    for tile in range(4 * c // half):
        val = range(tile * half, tile * half + half)
        gate = range(plan["gate_row0"] + tile * half, plan["gate_row0"] + tile * half + half)
        assert all(g == 4 * c + j for j, g in zip(val, gate))
        assert val[-1] < 4 * c <= gate[0] and gate[-1] < 8 * c


@pytest.mark.parametrize("c", [0, 8, 24, 1296, 2560])
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
