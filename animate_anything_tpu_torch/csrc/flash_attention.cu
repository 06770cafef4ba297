// Kernel 1: non-causal flash attention forward on the natural (b, s, h·d)
// projection layout.
//
// Replaces animate_anything_tpu/ops/flash_attention.py::_flash_forward_lanes
// (_lanes_kernel) and ::_flash_forward (_attn_kernel).  The TPU kernels hold a
// whole K/V row in VMEM and take a one-shot softmax; at s = 4096, d = 64 that
// is 1 MB of K+V per head, far past the 227 KB of shared memory an SM block
// may use.  Here K/V stream through shared memory in 64-key tiles with an
// online softmax (running row max and sum in fp32, accumulator rescaled per
// tile), so memory use is independent of s.
//
// Bound on the H100: tensor-core math (4·s²·d flops per head against 4·s·d
// bytes), so scores, probabilities and the output accumulator never leave
// registers: mma.sync m16n8k16 fragments with known layouts let the softmax
// run directly on the S accumulators and feed P to the second product as an
// A operand without a shared-memory round trip.  Heads are addressed by
// stride inside the (b, s, h·d) rows, so no head transpose is ever made, and
// odd head counts need no pairing.  The ragged K edge is masked in-kernel.
//
// Arithmetic: q is pre-scaled by 1/√d and rounded to bf16 before Q·Kᵀ, as
// the TPU backward kernels round q̂, so that the stored lse matches the
// scores the backward rebuilds; the softmax then runs in the exp2 domain
// (scores × log2 e in fp32).  The TPU forward kernels differ by where log2 e
// goes: they fold it into the pre-scale (q·log2 e/√d, then rounded); a caller
// whose q is already pre-scaled that way (kernel 11, csrc/ln_qkv.cu) passes
// scale = 1 and exp2_scale = 1, and gets that arithmetic.  When
// autograd needs it, the kernel also stores each row's log-sum-exp in the
// exp2 domain, lse2 = m + log2(l), fp32 (b, heads, sq), so the backward
// kernels (flash_attention_bwd.cu) rebuild P = exp2(s·log2 e − lse2) in one
// pass.
//
// Block: 4 warps x 16 query rows; grid (ceil(sq/64), b·h).
#include "common.cuh"

namespace aat {
namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int WARPS = 4;
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int heads, float scale, float exp2_scale) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per head row
  __shared__ __align__(16) bf16 Ks[BKV][LD];
  __shared__ __align__(16) bf16 Vs[BKV][LD];

  const int C = heads * D;
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)bi * sq * C + hi * D;
  const bf16* kb = k + (size_t)bi * sk * C + hi * D;
  const bf16* vb = v + (size_t)bi * sk * C + hi * D;
  bf16* ob = o + (size_t)bi * sq * C + hi * D;

  // Q tile, pre-scaled by 1/√d and rounded to bf16, staged through Ks, then
  // held in registers as A fragments.
  stage_rows<D, BQ, LD, WARPS * 32, true>(Ks, qb, q0, sq, C, scale);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&Ks[r0 + g][kk * 16 + 2 * t]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&Ks[r0 + g + 8][kk * 16 + 2 * t]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&Ks[r0 + g][kk * 16 + 2 * t + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&Ks[r0 + g + 8][kk * 16 + 2 * t + 8]);
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += BKV) {
    for (int idx = tid; idx < BKV * CHUNKS; idx += WARPS * 32) {
      const int r = idx / CHUNKS, cc = idx % CHUNKS;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * C + cc * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * C + cc * 8);
      }
      *reinterpret_cast<uint4*>(&Ks[r][cc * 8]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r][cc * 8]) = vv;
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows: BKV/8 n8 tiles.
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + 2 * t]);
        bfr[1] = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_16816(s[j], qf[kk], bfr);
      }
    }

    // Online softmax in the exp2 domain (scores × exp2_scale = log2 e).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float val = col < sk ? s[j][e] * exp2_scale : -CUDART_INF_F;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P·V: the S accumulator layout of two adjacent n8 tiles is the A
    // layout of one k16 step, so P goes straight from registers (as bf16).
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int dim = j * 8 + g;
        uint32_t bfr[2];
        bfr[0] = pack_bf16(Vs[key][dim], Vs[key + 1][dim]);
        bfr[1] = pack_bf16(Vs[key + 8][dim], Vs[key + 9][dim]);
        mma_16816(acc[j], pa, bfr);
      }
    }
    __syncthreads();
  }

  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  if (lse != nullptr && t == 0) {
    float* lb = lse + (size_t)blockIdx.y * sq;
    if (row_a < sq) lb[row_a] = m_run[0] + log2f(l_run[0]);
    if (row_b < sq) lb[row_b] = m_run[1] + log2f(l_run[1]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * C + col) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * C + col) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
            int sk, int heads, float scale, float exp2_scale, cudaStream_t stream) {
  dim3 grid((sq + BQ - 1) / BQ, b * heads);
  flash_fwd_kernel<D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, sq, sk, heads, scale, exp2_scale);
}

}  // namespace
}  // namespace aat

// q, o: (b, sq, heads·d); k, v: (b, sk, heads·d); all contiguous bf16.
// lse: null, or fp32 (b, heads, sq) for the row log-sum-exp (log2 domain).
// scale: the pre-scale of q (1/√d); exp2_scale: the factor that takes the
// scores to the exp2 domain (log2 e; 1 when q was pre-scaled by log2 e/√d).
AAT_EXPORT int aat_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int b, int sq, int sk, int heads, int d,
                                   float scale, float exp2_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 32: aat::launch<32>(q, k, v, o, l, b, sq, sk, heads, scale, exp2_scale, st); break;
    case 64: aat::launch<64>(q, k, v, o, l, b, sq, sk, heads, scale, exp2_scale, st); break;
    case 128: aat::launch<128>(q, k, v, o, l, b, sq, sk, heads, scale, exp2_scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
