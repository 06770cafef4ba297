// Flash attention backward (dq; dk, dv) on the natural (b, s, h·d)
// projection layout, non-causal, d in {32, 64, 128}.
//
// Replaces animate_anything_tpu/ops/flash_attention.py::_flash_backward_lanes
// (d = 64; _bwd_dq_lanes_kernel, _bwd_dkv_lanes_kernel) and ::_flash_backward
// (other head sizes; _bwd_dq_kernel, _bwd_dkv_kernel).  As in the forward,
// heads are addressed by stride inside the (b, s, h·d) rows: no head
// transpose, and odd head counts need no pairing.
//
// Bound on the H100: tensor-core math.  Per head the backward does five
// s_q x s_k x d products (recompute S, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K,
// dK = dSᵀ·Q), 10·sq·sk·d flops against ~16·s·d bytes of q, k, v, o, dO, dq,
// dk, dv.  So S, P, dP and dS never leave registers: mma.sync m16n8k16
// accumulators of S and dP are turned into P and dS in place, and feed the
// next product as A operands (the accumulator layout of two adjacent n8
// tiles is the A layout of one k16 step).
//
// Two kernels, no atomics, so the gradients are deterministic:
// - dq: one block per (b·h, 64-row q tile) loops over the K/V tiles.  It
//   takes the forward's per-row log-sum-exp (flash_attention.cu stores it
//   when autograd needs it), so P = exp2(S·log2 e − lse2) needs no second
//   pass over K to rebuild the row max and sum (the TPU kernel holds a whole
//   K row in VMEM for that).  It also computes Δ = rowsum(dO ⊙ O) in fp32 for
//   its rows and stores it for the second kernel.
// - dk/dv: one block per (b·h, 64-key tile) loops over every q tile, with
//   the fp32 dK and dV accumulators in registers.  The loop replaces the
//   TPU's sequential "arbitrary" grid axis over q chunks.  Each warp owns 16
//   keys and computes Sᵀ = K·Q̂ᵀ and dPᵀ = V·dOᵀ directly in the key-major
//   layout that dV = Pᵀ·dO and dK = dSᵀ·Q̂ need.
//
// Arithmetic of the TPU kernels: q is pre-scaled by 1/√d and rounded to bf16
// (Q̂) before Q̂·Kᵀ; p = exp(s − lse); ds = p ⊙ (dp − Δ); ds is rounded to bf16
// before dq = ds·K·(1/√d) and dk = dsᵀ·Q̂; p is rounded to bf16 before
// dv = pᵀ·dO.  Ragged edges: key columns past sk get p = 0 in the dq pass;
// query rows past sq are zero-filled with lse = +inf, so p = 0 and dO = 0
// there and they add nothing to dk, dv.
#include "common.cuh"

namespace aat {
namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 64;   // q rows per dq block
constexpr int BKV = 64;  // keys per tile (dq loop) and per dk/dv block
constexpr float kLog2e = 1.4426950408889634f;

// Fragment loads from a row-major shared tile m with row stride LD.
// A fragment: rows r0..r0+15, columns k0..k0+15.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* m, int r0, int k0, int g, int t) {
  a[0] = *reinterpret_cast<const uint32_t*>(m + (r0 + g) * LD + k0 + 2 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(m + (r0 + g + 8) * LD + k0 + 2 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(m + (r0 + g) * LD + k0 + 2 * t + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(m + (r0 + g + 8) * LD + k0 + 2 * t + 8);
}

// B fragment of X·Yᵀ with Y = m as [n][k]: rows n0..n0+7, columns k0..k0+15.
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* m, int n0, int k0, int g, int t) {
  b[0] = *reinterpret_cast<const uint32_t*>(m + (n0 + g) * LD + k0 + 2 * t);
  b[1] = *reinterpret_cast<const uint32_t*>(m + (n0 + g) * LD + k0 + 2 * t + 8);
}

// B fragment of X·Y with Y = m as [k][n]: rows k0..k0+15, column n0 + g.
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* m, int k0, int n0, int g, int t) {
  const bf16* c = m + (k0 + 2 * t) * LD + n0 + g;
  b[0] = pack_bf16(c[0], c[LD]);
  b[1] = pack_bf16(c[8 * LD], c[9 * LD]);
}

// Accumulators of two adjacent n8 tiles → the bf16 A fragment of one k16 step.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int sq, int sk, int heads,
                    float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Ks[BKV][LD];
  __shared__ __align__(16) bf16 Vs[BKV][LD];

  const int C = heads * D;
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bi * sq * C + hi * D, koff = (size_t)bi * sk * C + hi * D;
  const float* lse_b = lse + (size_t)blockIdx.y * sq;
  float* delta_b = delta + (size_t)blockIdx.y * sq;

  // Q̂ through Ks and dO through Vs into A fragments.
  stage_rows<D, BQ, LD, THREADS, true>(Ks, q + qoff, q0, sq, C, scale);
  stage_rows<D, BQ, LD, THREADS, false>(Vs, dout + qoff, q0, sq, C, 0.f);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag_a<LD>(qf[kk], &Ks[0][0], r0, kk * 16, g, t);
    frag_a<LD>(dof[kk], &Vs[0][0], r0, kk * 16, g, t);
  }

  // Δ = rowsum(dO ⊙ O) in fp32: two lanes per row of the warp's 16.
  float dl[2], l2[2];
  {
    const int r = lane >> 1, half = lane & 1, row = q0 + r0 + r;
    float acc = 0.f;
    if (row < sq) {
      const bf16* orow = o + qoff + (size_t)row * C + half * (D / 2);
#pragma unroll 8
      for (int i = 0; i < D / 2; ++i)
        acc += bf2f(orow[i]) * bf2f(Vs[r0 + r][half * (D / 2) + i]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0 && row < sq) delta_b[row] = acc;
    dl[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
  }
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  l2[0] = row_a < sq ? lse_b[row_a] : 0.f;
  l2[1] = row_b < sq ? lse_b[row_b] : 0.f;
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BKV) {
    stage_rows<D, BKV, LD, THREADS, false>(Ks, k + koff, k0, sk, C, 0.f);
    stage_rows<D, BKV, LD, THREADS, false>(Vs, v + koff, k0, sk, C, 0.f);
    __syncthreads();

    // S = Q̂·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows.
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[2], bv[2];
        frag_bt<LD>(bk, &Ks[0][0], j * 8, kk * 16, g, t);
        frag_bt<LD>(bv, &Vs[0][0], j * 8, kk * 16, g, t);
        mma_16816(s[j], qf[kk], bk);
        mma_16816(dp[j], dof[kk], bv);
      }
    }
    // dS = P ⊙ (dP − Δ), in place of S; masked key columns get P = 0.
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float p = col < sk ? exp2f(s[j][e] * kLog2e - l2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
    // dQ += dS·K (dS rounded to bf16).
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bk[2];
        frag_b<LD>(bk, &Ks[0][0], kk * 16, j * 8, g, t);
        mma_16816(acc[j], da, bk);
      }
    }
    __syncthreads();
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_a * C + col) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_b * C + col) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// BQ2: q rows per loop step; 32 at d = 128 to keep S, dP and the two
// d-wide accumulators inside the register file.
template <int D, int BQ2>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int heads,
                     float scale) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 Qs[BKV][LD];  // K tile first, then Q̂ tiles
  __shared__ __align__(16) bf16 Ds[BKV][LD];  // V tile first, then dO tiles
  __shared__ float lse_s[BQ2], delta_s[BQ2];

  const int C = heads * D;
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bi * sq * C + hi * D, koff = (size_t)bi * sk * C + hi * D;
  const float* lse_b = lse + (size_t)blockIdx.y * sq;
  const float* delta_b = delta + (size_t)blockIdx.y * sq;

  // This warp's 16 keys of K and V as A fragments.
  stage_rows<D, BKV, LD, THREADS, false>(Qs, k + koff, k0, sk, C, 0.f);
  stage_rows<D, BKV, LD, THREADS, false>(Ds, v + koff, k0, sk, C, 0.f);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag_a<LD>(kf[kk], &Qs[0][0], r0, kk * 16, g, t);
    frag_a<LD>(vf[kk], &Ds[0][0], r0, kk * 16, g, t);
  }
  __syncthreads();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BQ2) {
    stage_rows<D, BQ2, LD, THREADS, true>(Qs, q + qoff, q0, sq, C, scale);
    stage_rows<D, BQ2, LD, THREADS, false>(Ds, dout + qoff, q0, sq, C, 0.f);
    for (int i = threadIdx.x; i < BQ2; i += THREADS) {
      const bool real = q0 + i < sq;
      lse_s[i] = real ? lse_b[q0 + i] : CUDART_INF_F;
      delta_s[i] = real ? delta_b[q0 + i] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Q̂ᵀ and dPᵀ = V·dOᵀ: rows are this warp's keys, columns queries.
    float s[BQ2 / 8][4], dp[BQ2 / 8][4];
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bq[2], bd[2];
        frag_bt<LD>(bq, &Qs[0][0], j * 8, kk * 16, g, t);
        frag_bt<LD>(bd, &Ds[0][0], j * 8, kk * 16, g, t);
        mma_16816(s[j], kf[kk], bq);
        mma_16816(dp[j], vf[kk], bd);
      }
    }
    // Pᵀ in place of Sᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ − Δ) in place of dPᵀ.
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        const float p = exp2f(s[j][e] * kLog2e - lse_s[qc]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[qc]);
      }
    // dV += Pᵀ·dO and dK += dSᵀ·Q̂ (P and dS rounded to bf16).
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bdo[2], bq[2];
        frag_b<LD>(bdo, &Ds[0][0], kk * 16, j * 8, g, t);
        frag_b<LD>(bq, &Qs[0][0], kk * 16, j * 8, g, t);
        mma_16816(dv_acc[j], pa, bdo);
        mma_16816(dk_acc[j], da, bq);
      }
    }
    __syncthreads();
  }

  const int key_a = k0 + r0 + g, key_b = key_a + 8;
  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (key_a < sk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key_a * C + col) =
          pack_bf16(dk_acc[j][0], dk_acc[j][1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key_a * C + col) =
          pack_bf16(dv_acc[j][0], dv_acc[j][1]);
    }
    if (key_b < sk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key_b * C + col) =
          pack_bf16(dk_acc[j][2], dk_acc[j][3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key_b * C + col) =
          pack_bf16(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int b, int sq, int sk, int heads, float scale,
                       cudaStream_t stream) {
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  dim3 grid_q((sq + BQ - 1) / BQ, b * heads);
  flash_bwd_dq_kernel<D><<<grid_q, THREADS, 0, stream>>>(
      qp, kp, vp, static_cast<const bf16*>(o), dop, lp, dl, static_cast<bf16*>(dq), sq, sk,
      heads, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_k((sk + BKV - 1) / BKV, b * heads);
  flash_bwd_dkv_kernel<D, D == 128 ? 32 : 64><<<grid_k, THREADS, 0, stream>>>(
      qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, heads,
      scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aat

// q, o, dout, dq: (b, sq, heads·d); k, v, dk, dv: (b, sk, heads·d); all
// contiguous bf16.  lse: the forward's fp32 (b, heads, sq) row log-sum-exp
// (log2 domain); delta: fp32 (b, heads, sq) scratch.  scale: 1/√d.
AAT_EXPORT int aat_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int b, int sq,
                                       int sk, int heads, int d, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32:
      err = aat::launch_bwd<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, heads,
                                scale, st);
      break;
    case 64:
      err = aat::launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, heads,
                                scale, st);
      break;
    case 128:
      err = aat::launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, heads,
                                 scale, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
