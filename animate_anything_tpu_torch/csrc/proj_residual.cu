// Kernel 4: transformer output projection + bias + residual, with a
// per-(row slab, channel) Σy / Σy² epilogue of the stored output.
//
// Replaces animate_anything_tpu/ops/proj_residual.py::_pallas_proj (_kernel):
//     y[n, s] = h[n, s]·W + bias + residual[n, s]
// The consumer of y is always a GroupNorm, which takes the sums through
// group_affine(sums=) instead of reading y again.
//
// Bound on the H100: tensor-core math at k = c (2·k·c flops per row against
// (k + 2c)·2 bytes); the fusion saves the separate residual-add pass and the
// stats pass over y.  Design: a 128 x TN output tile (TN = 128, or 64 when c
// is not a multiple of 128) over the flattened n·s rows, so a tile may span
// slabs; warps own 64 x 32 WMMA sub-tiles (bf16 in, fp32 accumulate); the h
// and W k-tiles stream through a 3-deep cp.async ring, so the next tiles
// load while the current one multiplies.  The epilogue adds bias and
// residual, rounds to bf16, stores, and adds the column sums of the rounded
// values into zeroed fp32 buffers with atomics, one per slab n the tile
// touches (the TPU accumulated them on a sequential grid axis; Hopper blocks
// run in no order).
//
// Block: 256 (TN = 128) or 128 (TN = 64) threads; grid (ceil(n·s/128),
// ceil(c/TN)).
#include "common.cuh"

namespace aat {
namespace {

constexpr int TM = 128, TK = 32, LD = TK + 8, STAGES = 3;

template <int TN>
struct Cfg {
  static constexpr int WARPS_N = TN / 32;
  static constexpr int THREADS = 2 * WARPS_N * 32;
  static constexpr int CLD = TN + 4;
  static constexpr int PIPE_BYTES = STAGES * (TM + TN) * LD * 2;
  static constexpr int C_BYTES = TM * CLD * 4;
  static constexpr int SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

// cp.async one k-tile (TK columns) of `rows` rows of a row-major (rows_total,
// K) matrix into a (rows, LD) shared tile, zero-filling past the edges.
template <int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int rows, int rows_total, int k0, int K) {
  for (int idx = threadIdx.x; idx < rows * TK / 8; idx += THREADS) {
    const int r = idx / (TK / 8), cc = idx % (TK / 8);
    const bool ok = r0 + r < rows_total && k0 + cc * 8 < K;
    cp_async16(dst + r * LD + cc * 8, ok ? src + (size_t)(r0 + r) * K + k0 + cc * 8 : src,
               ok ? 16 : 0);
  }
}

template <int TN>
__global__ void __launch_bounds__(Cfg<TN>::THREADS)
proj_residual_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const float* __restrict__ bias, const bf16* __restrict__ res,
                     bf16* __restrict__ y, float* __restrict__ s1, float* __restrict__ s2,
                     int M, int s, int k, int c) {
  using namespace nvcuda;
  using C = Cfg<TN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * TM * LD;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / C::WARPS_N) * 64, wn = (warp % C::WARPS_N) * 32;
  const int KT = (k + TK - 1) / TK;

  auto load_stage = [&](int st, int kt) {
    if (kt < KT) {
      load_tile<C::THREADS>(As + st * TM * LD, h, m0, TM, M, kt * TK, k);
      load_tile<C::THREADS>(Bs + st * TN * LD, w, n0, TN, c, kt * TK, k);
    }
    cp_async_commit();  // empty groups keep the wait counts uniform
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load_stage(st, st);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for every thread; tile kt-1 fully consumed
    load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    const bf16* a_st = As + (kt % STAGES) * TM * LD;
    const bf16* b_st = Bs + (kt % STAGES) * TN * LD;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], a_st + (wm + i * 16) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], b_st + (wn + j * 16) * LD + kk, LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(smem);  // aliases the drained ring
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * C::CLD + wn + j * 16, acc[i][j], C::CLD,
                              wmma::mem_row_major);
  __syncthreads();
  bias_residual_stats<TM, TN, C::THREADS, C::CLD>(Cs, bias, res, y, s1, s2, m0, M, s, n0, c);
}

template <int TN>
int launch(const void* h, const void* w, const void* bias, const void* res, void* y, void* s1,
           void* s2, int n, int s, int k, int c, cudaStream_t stream) {
  using C = Cfg<TN>;
  auto kern = proj_residual_kernel<TN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = n * s;
  dim3 grid((M + TM - 1) / TM, (c + TN - 1) / TN);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(y), static_cast<float*>(s1),
      static_cast<float*>(s2), M, s, k, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// h: (n, s, k) bf16; w: (c, k) bf16 (torch Linear layout); bias: (c,) fp32;
// res, y: (n, s, c) bf16; s1, s2: (n, c) fp32, zeroed by the caller.
// k % 8 == 0, c % 8 == 0.
AAT_EXPORT int aat_proj_residual(const void* h, const void* w, const void* bias, const void* res,
                                 void* y, void* s1, void* s2, int n, int s, int k, int c,
                                 void* stream) {
  if (k % 8 != 0 || c % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 128 == 0) return aat::launch<128>(h, w, bias, res, y, s1, s2, n, s, k, c, st);
  return aat::launch<64>(h, w, bias, res, y, s1, s2, n, s, k, c, st);
}
