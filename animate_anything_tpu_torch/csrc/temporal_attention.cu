// Kernel 9: attention over the frame axis of (b, f, s, h·d) projections.
//
// Replaces animate_anything_tpu/ops/temporal_attention.py::_packed_forward
// (_kernel).  For every (batch, location, head) the f × f problem is
//     o_i = Σ_g bf16(softmax_g(q_i·k_g / √d)) · v_g,
// fp32 scores and softmax, the normalised probabilities rounded to bf16 before
// the fp32 P·V, the output rounded to bf16.  The TPU kernel packs ⌊128/f⌋
// locations into one MXU tile under a same-location mask, after pack copies
// in HBM; both are facts of the 128-wide MXU and are not carried over.
//
// Bound on the H100: device memory (q, k, v read once, o written once; at
// f = 17, d = 64 the math is 2·f·d FMAs per 4·d bytes of a row).  Design: for
// a fixed frame, one location's h·d channels are contiguous, and so are those
// of consecutive locations.  A block owns L consecutive locations × HB heads
// of one batch element and copies their q, k and v rows of all f frames into
// shared memory with cp.async, all in flight at once (rows past s
// zero-filled).  Each (location, head) problem then belongs to one warp: the
// f query rows in m16 tiles (rows past f zero), S = Q·Kᵀ on mma.sync
// m16n8k16 over the f keys in n8 tiles, the softmax on the S accumulators
// (keys past f masked), and P, normalised and rounded to bf16, fed straight
// from those accumulators as the A operand of O = P·V, as kernel 1 does.
// Head dims that are not a multiple of 16 are padded with zeros to the
// template's DP.  The output rows go over the problem's own q rows in shared
// memory, and the tile goes back to the (b, f, s, h·d) layout with 16-byte
// stores.  Rows of one location lie a whole frame apart, which would put the
// rows of an m16 tile in the same banks, so each row's 16-byte chunks are
// swizzled by its frame index.  No pack or unpack copies.
//
// Block: 8 warps; grid (ceil(s/L), ceil(heads/HB), b).
#include "common.cuh"

namespace aat {
namespace {

constexpr int WARPS = 8;
constexpr int SMEM_BUDGET = 110 * 1024;  // two blocks per SM
constexpr int MAX_SMEM = 232448;
constexpr int MAX_UNITS = 32;            // (location, head) problems per block

// Element offset of channel p of row (frame, l) in a tile of rows W wide:
// 16-byte chunk p/8 XOR (frame & swz), swz + 1 a power of two dividing W/8,
// so the swizzle stays inside the row.
__device__ __forceinline__ int tile_at(int frame, int l, int p, int L, int W, int swz) {
  return (frame * L + l) * W + ((((p >> 3) ^ (frame & swz)) << 3) | (p & 7));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// DP: the head dim padded to a multiple of 16 (d ≤ DP); NT: n8 key tiles,
// f ≤ 8·NT (NT even, so that pairs of them make the k16 steps of P·V).
template <int DP, int NT>
__global__ void __launch_bounds__(WARPS * 32)
temporal_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int f, int s,
                          int heads, int d, int L, int HB, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = heads * d;  // row stride of the projections
  const int W = HB * d;     // channels of a (frame, location) row of the tile
  const size_t tile = (size_t)f * L * W;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + tile;
  bf16* sv = sk + tile;

  const int s0 = blockIdx.x * L, h0 = blockIdx.y * HB, bi = blockIdx.z;
  const int hb = min(HB, heads - h0);
  const int wv = hb * d / 8;  // 16-byte vectors of one (frame, location) row
  const int nvec = f * L * wv;
  const int swz = min(8, (W / 8) & -(W / 8)) - 1;
  const size_t base = (size_t)bi * f * s * C + (size_t)h0 * d;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int c8 = i % wv, rest = i / wv, l = rest % L, fr = rest / L;
    const bool in = s0 + l < s;  // rows past s are zero-filled, nothing read
    const size_t goff = in ? base + ((size_t)fr * s + s0 + l) * C + c8 * 8 : 0;
    const int soff = tile_at(fr, l, c8 * 8, L, W, swz);
    cp_async16(sq + soff, q + goff, in ? 16 : 0);
    cp_async16(sk + soff, k + goff, in ? 16 : 0);
    cp_async16(sv + soff, v + goff, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int prob = warp; prob < L * hb; prob += WARPS) {
    const int l = prob / hb, p0 = (prob % hb) * d;
    for (int m0 = 0; m0 < f; m0 += 16) {
      const int ra = m0 + g, rb = ra + 8;  // this lane's two query rows
      uint32_t qa[DP / 16][4];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
        qa[kk][0] = ra < f && c0 < d ? ld32(sq + tile_at(ra, l, p0 + c0, L, W, swz)) : 0u;
        qa[kk][1] = rb < f && c0 < d ? ld32(sq + tile_at(rb, l, p0 + c0, L, W, swz)) : 0u;
        qa[kk][2] = ra < f && c1 < d ? ld32(sq + tile_at(ra, l, p0 + c1, L, W, swz)) : 0u;
        qa[kk][3] = rb < f && c1 < d ? ld32(sq + tile_at(rb, l, p0 + c1, L, W, swz)) : 0u;
      }

      // S = Q·Kᵀ over the key tiles that hold keys < f.
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        const int key = j * 8 + g;
        if (j * 8 < f) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
            uint32_t bk[2];
            bk[0] = key < f && c0 < d ? ld32(sk + tile_at(key, l, p0 + c0, L, W, swz)) : 0u;
            bk[1] = key < f && c1 < d ? ld32(sk + tile_at(key, l, p0 + c1, L, W, swz)) : 0u;
            mma_16816(sc[j], qa[kk], bk);
          }
        }
      }

      // Softmax of rows ra (e = 0, 1) and rb (e = 2, 3) over keys < f; each
      // row's values sit in the four lanes of a quad.
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          sc[j][e] = col < f ? sc[j][e] * scale : -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = expf(sc[j][e] - mx[e >> 1]);  // 0 at the masked keys
          sum[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      }

      // O = P·V: two adjacent n8 tiles of S are one k16 step's A operand.
      float acc[DP / 8][4];
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (kk * 16 < f) {
          uint32_t pa[4];
          pa[0] = pack_bf16(sc[2 * kk][0] / sum[0], sc[2 * kk][1] / sum[0]);
          pa[1] = pack_bf16(sc[2 * kk][2] / sum[1], sc[2 * kk][3] / sum[1]);
          pa[2] = pack_bf16(sc[2 * kk + 1][0] / sum[0], sc[2 * kk + 1][1] / sum[0]);
          pa[3] = pack_bf16(sc[2 * kk + 1][2] / sum[1], sc[2 * kk + 1][3] / sum[1]);
          const int key = kk * 16 + 2 * t;
#pragma unroll
          for (int jd = 0; jd < DP / 8; ++jd) {
            if (jd * 8 < d) {
              const int dim = jd * 8 + g;
              bf16 e[4];  // keys key, key + 1, key + 8, key + 9
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int kr = key + (i & 1) + (i >> 1) * 8;
                e[i] = kr < f ? sv[tile_at(kr, l, p0 + dim, L, W, swz)] : f2bf(0.f);
              }
              const uint32_t bv[2] = {pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3])};
              mma_16816(acc[jd], pa, bv);
            }
          }
        }
      }

      // The output rows over this problem's own q rows (already in qa).
      __syncwarp();
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) {
        const int col = jd * 8 + 2 * t;
        if (col < d) {
          if (ra < f)
            *reinterpret_cast<uint32_t*>(sq + tile_at(ra, l, p0 + col, L, W, swz)) =
                pack_bf16(acc[jd][0], acc[jd][1]);
          if (rb < f)
            *reinterpret_cast<uint32_t*>(sq + tile_at(rb, l, p0 + col, L, W, swz)) =
                pack_bf16(acc[jd][2], acc[jd][3]);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int c8 = i % wv, rest = i / wv, l = rest % L, fr = rest / L;
    if (s0 + l >= s) continue;
    const size_t goff = base + ((size_t)fr * s + s0 + l) * C + c8 * 8;
    *reinterpret_cast<uint4*>(o + goff) =
        *reinterpret_cast<const uint4*>(sq + tile_at(fr, l, c8 * 8, L, W, swz));
  }
}

template <int DP, int NT>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int f, int s, int heads,
           int d, cudaStream_t stream) {
  // (location, head) problems per block, within the shared-memory budget:
  // all heads of L locations when they fit, else an even split of the heads
  // of one location.
  const int unit_bytes = 3 * f * d * (int)sizeof(bf16);
  const int units = max(1, min(SMEM_BUDGET / unit_bytes, MAX_UNITS));
  int L = 1, HB = heads;
  if (units >= heads) {
    L = max(1, min(units / heads, s));
  } else {
    const int groups = (heads + units - 1) / units;
    HB = (heads + groups - 1) / groups;
  }
  const size_t smem = (size_t)L * HB * unit_bytes;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = temporal_attention_kernel<DP, NT>;
  // Once per template instance, not on every launch: the largest dynamic
  // shared memory any launch may ask for, and the carveout that favours it.
  static const cudaError_t attr = [] {
    auto k = temporal_attention_kernel<DP, NT>;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((s + L - 1) / L, (heads + HB - 1) / HB, b);
  kern<<<grid, WARPS * 32, smem, stream>>>(q, k, v, o, f, s, heads, d, L, HB,
                                           1.f / sqrtf((float)d));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int f, int s,
             int heads, int d, cudaStream_t stream) {
  if (f <= 32) return launch<DP, 4>(q, k, v, o, b, f, s, heads, d, stream);
  return launch<DP, 16>(q, k, v, o, b, f, s, heads, d, stream);
}

}  // namespace
}  // namespace aat

// q, k, v, o: (b, f, s, heads·d) contiguous bf16.  2 <= f <= 128, d % 8 == 0,
// d <= 128.
AAT_EXPORT int aat_temporal_attention(const void* q, const void* k, const void* v, void* o, int b,
                                      int f, int s, int heads, int d, void* stream) {
  using aat::bf16;
  if (f < 2 || f > 128 || d % 8 != 0 || d < 8 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16) return aat::launch_f<16>(qb, kb, vb, ob, b, f, s, heads, d, st);
  if (d <= 32) return aat::launch_f<32>(qb, kb, vb, ob, b, f, s, heads, d, st);
  if (d <= 64) return aat::launch_f<64>(qb, kb, vb, ob, b, f, s, heads, d, st);
  return aat::launch_f<128>(qb, kb, vb, ob, b, f, s, heads, d, st);
}
