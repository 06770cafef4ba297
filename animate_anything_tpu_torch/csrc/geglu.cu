// Kernel 2: fused LayerNorm -> GEGLU feed-forward -> + residual, one pass.
//
// Replaces animate_anything_tpu/ops/geglu.py::_pallas_ln_geglu (_kernel,
// c <= 640) and ::_pallas_ln_geglu_wide (_wide_kernel, c = 1280) with one
// kernel for every width:
//     y = x + W2·(val ⊙ gelu_tanh(gate)) + b2,   [val ‖ gate] = LN(x)·W1 + b1
// with LN statistics in fp32 and the (rows, 8c) GEGLU hidden never written to
// device memory.
//
// Bound on the H100: tensor-core math (24·c² flops per row) as long as the
// weights (12·c² bytes) are re-read from L2, not HBM.  Design: a block owns R
// rows.  Their LayerNorm'd copy (bf16, R x c) sits in shared memory for the
// whole kernel, and the fp32 output accumulator (R x c) sits in the warps'
// registers (RM x NF WMMA fragments per warp), so nothing but the hidden
// stream moves.  The 4c hidden columns are streamed 64 at a time: the val and
// gate halves (R x 128) are one product against 128 rows of W1, GELU·val goes
// to shared memory as bf16, and that slab is folded into the accumulator by a
// product against 64 columns of W2.  R shrinks as c grows (128 / 64 / 32 rows
// at c = 320 / 640 / 1280, ~20 accumulator fragments per warp, the most the
// register file holds) and R·c bf16 LN'd rows must fit shared memory; the
// cost is that W1 and W2 are re-streamed from L2 once per row block, n/R
// times in all, instead of the TPU's 256..512-row VMEM blocks.  Splitting the
// output columns over blocks instead would recompute LN·W1 (2/3 of the
// flops) in every block.
//
// Block: 8 warps; grid ceil(n / R).
#include "common.cuh"

namespace aat {
namespace {

using namespace nvcuda;

constexpr int HB = 64;  // hidden columns (of val and of gate) per step
constexpr int WARPS = 8;
constexpr int HLD = 2 * HB + 4;
constexpr int ALD = HB + 8;

size_t smem_bytes(int R, int c) {
  return (size_t)R * (c + 8) * sizeof(bf16) + (size_t)R * HLD * sizeof(float) +
         (size_t)R * ALD * sizeof(bf16) + (size_t)WARPS * 256 * sizeof(float);
}

template <int RM, int NF>
__global__ void __launch_bounds__(WARPS * 32)
ln_geglu_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ y, int n, int c, float eps) {
  constexpr int R = RM * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldl = c + 8;
  bf16* lns = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(lns + R * ldl);
  bf16* act = reinterpret_cast<bf16*>(hs + R * HLD);
  float* scratch = reinterpret_cast<float*>(act + R * ALD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * R;
  const int inner = 4 * c;
  const int ncf = c / 16;

  // LayerNorm of the block's rows (two-pass fp32 statistics), stored as bf16.
  for (int r = warp; r < R; r += WARPS) {
    const int row = row0 + r;
    bf16* dst = lns + r * ldl;
    if (row >= n) {
      for (int i = lane; i < c; i += 32) dst[i] = f2bf(0.f);
      continue;
    }
    const bf16* src = x + (size_t)row * c;
    float sum = 0.f;
    for (int i = lane; i < c; i += 32) sum += bf2f(src[i]);
    const float mu = warp_sum(sum) / c;
    float sq = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float d = bf2f(src[i]) - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / c + eps);
    for (int i = lane; i < c; i += 32)
      dst[i] = f2bf((bf2f(src[i]) - mu) * rstd * ln_s[i] + ln_b[i]);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RM][NF];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[i][f], 0.f);

  for (int j0 = 0; j0 < inner; j0 += HB) {
    // [val ‖ gate] slab (R x 128): warps 0-3 take val columns, 4-7 gate.
    {
      const int wrow = warp < 4 ? j0 + warp * 16 : inner + j0 + (warp - 4) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) wmma::fill_fragment(h[i], 0.f);
      for (int kk = 0; kk < c; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, w1 + (size_t)wrow * c + kk, c);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::load_matrix_sync(afr, lns + i * 16 * ldl + kk, ldl);
          wmma::mma_sync(h[i], afr, bfr, h[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
        wmma::store_matrix_sync(hs + i * 16 * HLD + warp * 16, h[i], HLD, wmma::mem_row_major);
    }
    __syncthreads();

    // act = (val + b1v) · gelu_tanh(gate + b1g), rounded to bf16.
    for (int idx = tid; idx < R * HB; idx += WARPS * 32) {
      const int r = idx / HB, i = idx % HB;
      const float val = hs[r * HLD + i] + b1[j0 + i];
      const float gate = hs[r * HLD + HB + i] + b1[inner + j0 + i];
      const float th = tanhf(0.7978845608028654f * (gate + 0.044715f * gate * gate * gate));
      act[r * ALD + i] = f2bf(val * (0.5f * gate * (1.f + th)));
    }
    __syncthreads();

    // acc += act (R x 64) · W2[:, j0:j0+64]ᵀ; warp w owns output column
    // fragments w, w+8, ...
#pragma unroll
    for (int kk = 0; kk < HB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) wmma::load_matrix_sync(afr[i], act + i * 16 * ALD + kk, ALD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int cf = warp + f * WARPS;
        if (cf < ncf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, w2 + (size_t)cf * 16 * inner + j0 + kk, inner);
#pragma unroll
          for (int i = 0; i < RM; ++i) wmma::mma_sync(acc[i][f], afr[i], bfr, acc[i][f]);
        }
      }
    }
    __syncthreads();
  }

  // y = acc + b2 + x, through a per-warp 16x16 staging tile.
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int cf = warp + f * WARPS;
      if (cf < ncf) {
        wmma::store_matrix_sync(sc, acc[i][f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = row0 + i * 16 + e / 16, col = cf * 16 + e % 16;
          if (row < n) {
            const size_t off = (size_t)row * c + col;
            y[off] = f2bf(sc[e] + b2[col] + bf2f(x[off]));
          }
        }
        __syncwarp();
      }
    }
}

template <int RM, int NF>
int launch(const void* x, const void* s, const void* b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, int n, int c, float eps,
           cudaStream_t stream) {
  constexpr int R = RM * 16;
  const size_t smem = smem_bytes(R, c);
  auto kern = ln_geglu_kernel<RM, NF>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(n + R - 1) / R, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y), n, c, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// x, y: (n, c) bf16; w1: (8c, c) bf16 [val rows, then gate rows]; w2: (c, 4c)
// bf16; ln_s, ln_b, b2: (c,) fp32; b1: (8c,) fp32.  c % 16 == 0, c <= 1280.
AAT_EXPORT int aat_ln_geglu(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y, int n,
                            int c, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 16 != 0 || c > 1280) return static_cast<int>(cudaErrorInvalidValue);
  // NF output-column fragments per warp cover ncf = c/16 fragments over 8 warps.
  if (c <= 384) return aat::launch<8, 3>(x, ln_s, ln_b, w1, b1, w2, b2, y, n, c, eps, st);
  if (c <= 640) return aat::launch<4, 5>(x, ln_s, ln_b, w1, b1, w2, b2, y, n, c, eps, st);
  return aat::launch<2, 10>(x, ln_s, ln_b, w1, b1, w2, b2, y, n, c, eps, st);
}
