// Kernel 2: LayerNorm -> GEGLU feed-forward -> + residual, on TMA and wgmma.
//
// Replaces animate_anything_tpu/ops/geglu.py::_pallas_ln_geglu (_kernel,
// c <= 640) and ::_pallas_ln_geglu_wide (_wide_kernel, 128-aligned c from
// 768 to 2432) with one code path for every c % 8 == 0 up to 4096 (the
// wrapper zero-pads other widths to the next multiple of 8, below):
//     y = x + W2·(val ⊙ gelu_tanh(gate)) + b2,   [val ‖ gate] = LN(x)·W1 + b1
// with LN statistics in fp32, LN(x) rounded to bf16 before W1, the GEGLU
// product rounded to bf16 before W2 and the residual added in fp32.
//
// Bound on the H100: tensor-core math, 24·c² flops a row against 4·c bytes
// of x and y (the weights, 24·c² bytes, stay in L2).  The TPU kernels keep
// the (rows, c) fp32 output accumulator in VMEM while the 4c hidden streams
// past; on Hopper one wgmma warpgroup owns 64 rows, and a 64 x c fp32
// accumulator is c/2 registers a thread (640 at c = 1280, past the 255 a
// thread may have), so the whole hidden cannot stay on chip for every c.
// Design: three launches, the two products as TMA + wgmma GEMMs with fused
// prologue and epilogue:
// - LN: 8 to 32 lanes a row by width, the row read once into registers,
//   fp32 two-pass statistics, LN(x) stored as bf16 (4·n·c bytes);
// - GEMM 1, act = GEGLU(LN(x)·W1ᵀ + b1): each tile pairs val columns
//   [j, j + BN/2) with gate columns [4c + j, 4c + j + BN/2) as two TMA
//   boxes of one W1 map stacked in one B tile, so a thread holds each
//   val/gate pair in one accumulator; the epilogue adds b1, takes
//   val·gelu_tanh(gate) in fp32 and stores act (n x 4c) as bf16;
// - GEMM 2, y = act·W2ᵀ + b2 + x: the epilogue adds b2 and the residual in
//   fp32 and stores y as bf16.
// The fusion boundary differs from the TPU kernels' in one place: act, 4c
// wide in bf16, goes through device memory (16·n·c bytes written and read
// back: at the H100's 3.35 TB/s at most 0.34 ms on the main path, beside
// its 0.35-0.89 ms FLOP bound at 989 TFLOP/s); no fp32 or 8c-wide hidden
// ever does, and both biases and the residual stay fused.
// Both GEMMs: persistent blocks (one a SM, tile after tile with the
// output-column tile fastest, so the blocks in flight share A rows in L2);
// two consumer warpgroups own 64 rows each of a 128-row tile and issue
// m64nBNk16 wgmma from a ring of 64-column K stages (128-byte swizzle, both
// operands K-major as the torch layouts store them), while a producer warp
// (or, at BN = 256, where the accumulator needs more than the 168
// registers a thread of a 288-thread block, thread 0 between its steps)
// keeps TMA loads in flight on full/empty mbarriers through the tile
// boundaries.  The epilogue writes each warpgroup's 64-row output tile into
// shared memory in TMA's swizzle (GEMM 2 over the residual tile, TMA-loaded
// there during the mainloop) and stores it with one TMA store, so global
// memory sees whole rows, not 4-byte pieces.  Rows past n and columns past
// c read as zeros through the maps and are not stored; where 4c is not a
// multiple of GEMM 1's BN/2 val columns, its last column tile reads gate
// rows as val rows for act columns past 4c, which are not stored.
// TMA needs 16-byte row strides, so c % 8 == 0.  At another c the wrapper
// runs the kernel at cp = c rounded up to 8: x, the LN scale and bias, b2
// and each weight zero-padded (W1's val and gate halves each to 4cp rows),
// the LN statistics over the first c columns (cs = c below), y cut back to
// c columns.  The zero columns add nothing: LN(x) there is 0·rstd·0 + 0,
// the padded act columns are (0 + 0)·gelu(0 + 0), and the padded W2 rows
// and columns are zero.
// Tiles, ring depth, grid and shared-memory bytes come from the wrapper's
// launch plan (ops/geglu.py::launch_plan), checked here.  The LN pass and
// the GEMM are in gemm.cuh, which kernel 5 shares.
#include "gemm.cuh"

// x, y: (n, c) bf16; w1: (2·inner, c) bf16 [val rows, then gate rows]; w2:
// (c, inner) bf16; ln_s, ln_b, b2: (c,) fp32; b1: (2·inner,) fp32; ln: (n, c)
// and act: (n, inner) bf16 scratch.  inner = 4c, or a tensor-parallel
// rank's share of it (val columns and gate columns of one range, paired as
// here); c % 8 == 0, c <= 4096, inner % 8 == 0; the LN statistics over the
// first cs columns (cs <= c; the rest zero padding); all 16-byte aligned.
// partial != 0: GEMM 2 without b2 and x (the rank's share of W2·act, which
// the ranks sum before adding them once; b2 unread).  The launch plan
// (ops/geglu.py::launch_plan): GEMM 1's tile width bn1 (128 or 256: bn1/2
// val and bn1/2 gate columns), ring stages, grid and dynamic shared bytes;
// GEMM 2's likewise (bn2 in 64, 128, 160, 256); gate_row0 = inner.
AAT_EXPORT int aat_ln_geglu(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y, void* ln,
                            void* act, int n, int c, int cs, int inner, int partial, float eps,
                            int bn1, int stages1, int grid1, int smem1, int bn2, int stages2,
                            int grid2, int smem2, int gate_row0, void* stream) {
  using namespace aat;
  using namespace aat::gemm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || c % 8 != 0 || c > 4096 || inner < 8 || inner % 8 != 0 || inner > 4 * c ||
      gate_row0 != inner)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_layer_norm<ln_geglu_ff>(x, ln_s, ln_b, ln, n, c, cs, eps, st);
  if (err) return err;

  const int row_tiles = (n + BM - 1) / BM;
  GemmParams p1 = {};
  p1.bias = static_cast<const float*>(b1);
  p1.m = n;
  p1.n = inner;
  p1.k = c;
  p1.gate_row0 = gate_row0;
  p1.col_tiles = (inner + bn1 / 2 - 1) / (bn1 / 2);
  p1.tiles = row_tiles * p1.col_tiles;
  p1.stages = stages1;
  if (bn1 == 256)
    err = launch_gemm<256, true, ln_geglu_ff>(p1, ln, w1, 2 * inner, act, nullptr, grid1, smem1,
                                              st);
  else if (bn1 == 128)
    err = launch_gemm<128, true, ln_geglu_ff>(p1, ln, w1, 2 * inner, act, nullptr, grid1, smem1,
                                              st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;

  // GEMM 2: y = act·W2ᵀ + b2 + x, or act·W2ᵀ alone (bn2 in 256, 160, 128, 64)
  return gemm_bias_residual<ln_geglu_ff>(act, w2, partial ? nullptr : b2, partial ? nullptr : x,
                                         y, n, c, inner, bn2, stages2, grid2, smem2, st);
}
