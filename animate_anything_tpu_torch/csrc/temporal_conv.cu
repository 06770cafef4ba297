// Kernel 3: one TemporalConvLayer stage, GroupNorm-apply -> SiLU -> 3-tap
// frame conv (+ residual), with a per-(batch, frame, channel) Σy / Σy²
// epilogue of the stored output.
//
// Replaces animate_anything_tpu/ops/temporal_conv.py::_pallas_stage
// (_kernel).  Per output row (b, f, s):
//     y = Σ_{t=-1..1} SiLU(a_b·x[b, f+t, s] + b_b)·W_t + bias (+ residual)
// with zero frames past both ends.  The GroupNorm statistics are already
// folded into the per-(batch, channel) affine (a, b) by group_affine.
//
// Bound on the H100: tensor-core math (6·cin·cout flops per row against
// (cin + cout)·2 bytes).  Design: the three taps are one GEMM with K = 3·cin
// over the weight repacked as (cout, 3, cin); each 64-row tile stays inside
// one (batch, frame) slab of s rows, and its A operand is produced on the
// way into shared memory: the normalise + SiLU is applied to the x rows of
// frame f + t - 1 (or zeros past the ends), so the activation never exists
// in device memory.  The TPU kernel accumulated the sums across a sequential
// grid axis; here tiles finish in no order, so the epilogue adds each tile's
// column sums into zeroed fp32 buffers with atomics.  The TPU's c <= 640
// gate was a VMEM limit: this kernel runs at every width on one path.
//
// Block: 128 threads, 64 x 64 output tile; grid (ceil(s/64), b·f, ceil(cout/64)).
#include "common.cuh"

namespace aat {
namespace {

constexpr int TM = 64, TN = 64, TK = 32, LD = TK + 8, CLD = TN + 4;
constexpr int THREADS = 128;

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// C = A·Bᵀ for one 64x64 tile: four warps own 32x32 quadrants (WMMA, bf16 in,
// fp32 accumulate).  A is produced k-tile by k-tile by the caller's loader
// into shared memory; B is the (N, K) row-major weight, read as a
// column-major K x N operand.  K must be a multiple of 8.
template <typename ALoad>
__device__ __forceinline__ void gemm(const ALoad& aload, const bf16* __restrict__ w,
                                     int N, int K, int n0, bf16* As, bf16* Bs,
                                     Acc (&acc)[2][2]) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    aload(As, k0);
    for (int idx = tid; idx < TN * TK / 8; idx += THREADS) {
      const int r = idx / (TK / 8), cc = idx % (TK / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N && k0 + cc * 8 < K)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k0 + cc * 8);
      *reinterpret_cast<uint4*>(Bs + r * LD + cc * 8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LD + kk, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Park the accumulators in a (TM, CLD) fp32 shared tile for the epilogue.
__device__ __forceinline__ void store(float* Cs, Acc (&acc)[2][2]) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * CLD + wn + j * 16, acc[i][j], CLD,
                              wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
tap_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ sh, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ res,
                bf16* __restrict__ y, float* __restrict__ s1, float* __restrict__ s2, int f,
                int s, int cin, int cout) {
  __shared__ __align__(128) bf16 As[TM * LD];
  __shared__ __align__(128) bf16 Bs[TN * LD];
  __shared__ __align__(128) float Cs[TM * CLD];

  const int slab = blockIdx.y, bi = slab / f, fi = slab % f;
  const int s0 = blockIdx.x * TM, n0 = blockIdx.z * TN;
  const float* ab = a + (size_t)bi * cin;
  const float* bb = sh + (size_t)bi * cin;

  auto aload = [&](bf16* dst, int k0) {
    const int tap = k0 / cin, i0 = k0 - tap * cin;  // a K tile never straddles taps
    const int frame = fi + tap - 1;
    const bool live = frame >= 0 && frame < f;
    const bf16* src = live ? x + ((size_t)bi * f + frame) * s * cin : x;
    for (int idx = threadIdx.x; idx < TM * TK / 8; idx += THREADS) {
      const int r = idx / (TK / 8), cc = idx % (TK / 8);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (live && s0 + r < s) {
        const int ch = i0 + cc * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(s0 + r) * cin + ch);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
        bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float z = bf2f(xv[e]) * ab[ch + e] + bb[ch + e];
          ov[e] = f2bf(0.5f * z * (1.f + tanhf(0.5f * z)));  // SiLU, tanh identity
        }
      }
      *reinterpret_cast<uint4*>(dst + r * LD + cc * 8) = out;
    }
  };

  Acc acc[2][2];
  gemm(aload, w, cout, 3 * cin, n0, As, Bs, acc);
  store(Cs, acc);
  bias_residual_stats<TM, TN, THREADS, CLD>(Cs, bias, res, y, s1, s2, slab * s + s0,
                                            (slab + 1) * s, s, n0, cout);
}

}  // namespace
}  // namespace aat

// x: (bsz, f, s, cin) bf16; a, sh: (bsz, cin) fp32; w: (cout, 3, cin) bf16;
// bias: (cout,) fp32; res: (bsz, f, s, cout) bf16 or null; y: (bsz, f, s, cout)
// bf16; s1, s2: (bsz, f, cout) fp32, zeroed by the caller.  cin % 32 == 0.
AAT_EXPORT int aat_tap_conv(const void* x, const void* a, const void* sh, const void* w,
                            const void* bias, const void* res, void* y, void* s1, void* s2,
                            int bsz, int f, int s, int cin, int cout, void* stream) {
  using namespace aat;
  if (cin % TK != 0 || cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((s + TM - 1) / TM, bsz * f, (cout + TN - 1) / TN);
  tap_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(sh),
      static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(y), static_cast<float*>(s1), static_cast<float*>(s2), f, s, cin, cout);
  return static_cast<int>(cudaGetLastError());
}
