// Kernel 11: LayerNorm rows -> q, k, v projections, the front half of
// animate_anything_tpu/ops/attic/ln_qkv_attention.py::_pallas_fwd (_kernel);
// kernel 1 (csrc/flash_attention.cu) is the back half.
//     ln = bf16(LN(x)),  q = bf16(ln·Wq · log2 e/√d),  k = bf16(ln·Wk),  v = bf16(ln·Wv)
// with the LayerNorm statistics in fp32 (two passes over the row) and fp32
// accumulation, q pre-scaled and rounded as the TPU kernel does before its
// exp2-domain softmax.
//
// The TPU kernel keeps the whole (s, c) sample and one head pair's K/V in
// VMEM and runs attention in the same program.  A Hopper block has 227 KB of
// shared memory, less than one 4096 × 320 sample, so the work is split at the
// one seam where the TPU kernel's intermediate is smallest: q, k and v go to
// device memory in the (b, s, h·d) layout that kernel 1 reads by stride (run
// with pre-scaled q), and the normalised rows never do.
//
// Bound on the H100: tensor-core math (6·c·h·d flops per row against 2·c +
// 6·h·d bytes).  Design: the LN-prologue GEMM of kernel 2 (csrc/geglu.cu) in
// its simplest form.  A block owns BM rows × BN output columns of [q ‖ k ‖ v]
// (a column tile never straddles two of them, h·d being a multiple of 64).
// It first takes its rows' mean and 1/σ, then streams K in 64-channel chunks:
// x is normalised on its way into shared memory (bf16), the weight chunk is
// copied beside it, and each warp runs mma.sync m16n8k16 on 16 rows × BN.
// The LayerNorm of a row is recomputed by each of the 3·h·d/BN column blocks
// from L2, which is cheaper than a round trip of the normalised rows.
//
// Block: 4 warps; grid (ceil(n/BM), 3·h·d/BN).
#include "common.cuh"

namespace aat {
namespace {

constexpr int BM = 64, BN = 64, KC = 64, WARPS = 4;
constexpr int LD = KC + 8;  // conflict-free 4-byte fragment loads

__global__ void __launch_bounds__(WARPS * 32)
ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
              const float* __restrict__ ln_b, const bf16* __restrict__ wq,
              const bf16* __restrict__ wk, const bf16* __restrict__ wv, bf16* __restrict__ q,
              bf16* __restrict__ k, bf16* __restrict__ v, int n, int c, int hd, float eps,
              float qscale) {
  __shared__ __align__(16) bf16 As[BM][LD];
  __shared__ __align__(16) bf16 Bs[BN][LD];
  __shared__ float mu_s[BM], rstd_s[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int which = blockIdx.y * BN / hd;  // 0: q, 1: k, 2: v
  const int col0 = blockIdx.y * BN - which * hd;
  const bf16* w = which == 0 ? wq : (which == 1 ? wk : wv);
  bf16* out = which == 0 ? q : (which == 1 ? k : v);
  const float oscale = which == 0 ? qscale : 1.f;

  // Row statistics: two passes in fp32, as the plain LayerNorm.
  for (int r = warp; r < BM; r += WARPS) {
    const int row = m0 + r;
    float mu = 0.f, rstd = 0.f;
    if (row < n) {
      const bf16* src = x + (size_t)row * c;
      float sum = 0.f;
      for (int i = lane; i < c; i += 32) sum += bf2f(src[i]);
      mu = warp_sum(sum) / c;
      float sq = 0.f;
      for (int i = lane; i < c; i += 32) {
        const float dlt = bf2f(src[i]) - mu;
        sq += dlt * dlt;
      }
      rstd = rsqrtf(warp_sum(sq) / c + eps);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int r0 = warp * 16;

  for (int k0 = 0; k0 < c; k0 += KC) {
    // A: the chunk's normalised rows (zero past n and past c); B: the
    // weight rows of this column tile over the same channels.
    for (int idx = tid; idx < BM * KC / 8; idx += WARPS * 32) {
      const int r = idx / (KC / 8), ch = k0 + (idx % (KC / 8)) * 8;
      uint4 av = make_uint4(0u, 0u, 0u, 0u), bv = av;
      if (ch < c) {
        if (m0 + r < n) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * c + ch));
          const bf16* xe = reinterpret_cast<const bf16*>(&raw);
          bf16* ae = reinterpret_cast<bf16*>(&av);
          const float mu = mu_s[r], rstd = rstd_s[r];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            ae[e] = f2bf((bf2f(xe[e]) - mu) * rstd * ln_s[ch + e] + ln_b[ch + e]);
        }
        bv = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(col0 + r) * c + ch));
      }
      *reinterpret_cast<uint4*>(&As[r][(idx % (KC / 8)) * 8]) = av;
      *reinterpret_cast<uint4*>(&Bs[r][(idx % (KC / 8)) * 8]) = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&As[r0 + g][kk * 16 + 2 * t]);
      a[1] = *reinterpret_cast<const uint32_t*>(&As[r0 + g + 8][kk * 16 + 2 * t]);
      a[2] = *reinterpret_cast<const uint32_t*>(&As[r0 + g][kk * 16 + 2 * t + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&As[r0 + g + 8][kk * 16 + 2 * t + 8]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Bs[j * 8 + g][kk * 16 + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Bs[j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_16816(acc[j], a, b);
      }
    }
    __syncthreads();
  }

  const int row_a = m0 + r0 + g, row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (row_a < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_a * hd + col) =
          pack_bf16(acc[j][0] * oscale, acc[j][1] * oscale);
    if (row_b < n)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_b * hd + col) =
          pack_bf16(acc[j][2] * oscale, acc[j][3] * oscale);
  }
}

}  // namespace
}  // namespace aat

// x: (n, c) bf16; ln_s, ln_b: (c,) fp32; wq, wk, wv: (hd, c) bf16 (each row
// one output channel); q, k, v: (n, hd) bf16.  c % 8 == 0, hd % 64 == 0.
// qscale: the factor applied to q before its rounding (log2 e/√d).
AAT_EXPORT int aat_ln_qkv(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                          const void* wk, const void* wv, void* q, void* k, void* v, int n, int c,
                          int hd, float eps, float qscale, void* stream) {
  using aat::bf16;
  if (c % 8 != 0 || hd % aat::BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + aat::BM - 1) / aat::BM, 3 * hd / aat::BN);
  aat::ln_qkv_kernel<<<grid, aat::WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<bf16*>(q), static_cast<bf16*>(k),
      static_cast<bf16*>(v), n, c, hd, eps, qscale);
  return static_cast<int>(cudaGetLastError());
}
