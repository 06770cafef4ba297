// Kernel 1: non-causal flash attention forward on the natural (b, s, h·d)
// projection layout, on TMA and wgmma.
//
// Replaces animate_anything_tpu/ops/flash_attention.py::_flash_forward_lanes
// (_lanes_kernel) and ::_flash_forward (_attn_kernel).  The TPU kernels hold a
// whole K/V row in VMEM and take a one-shot softmax; at s = 4096, d = 64 that
// is 1 MB of K+V per head, far past the 227 KB of shared memory an SM block
// may use.  Here K/V stream through shared memory in tiles with an online
// softmax (running row max and sum in fp32, accumulator rescaled per tile),
// so memory use is independent of s.
//
// Bound on the H100: tensor-core math (4·sq·sk·d flops per head against
// 2·(sq + sk)·d·2 bytes), and on the way there the softmax's exp2 per score.
// What the design does about it:
// - one block per 128 query rows x one (sample, head): two consumer
//   warpgroups of 64 rows each run S = Q̂·Kᵀ and O += P·V as wgmma, Hopper's
//   only path to the full tensor-core rate.  For d ≤ 160 one thread of a
//   third, producer warpgroup issues the TMA loads and nothing else, and
//   setmaxnreg moves its registers to the consumers; yet ptxas compiles a
//   384-thread block's consumers for 168 registers a thread, too few for
//   the 64 x d fp32 output accumulators above d = 160, so there the block
//   is the two consumer warpgroups alone (255 registers a thread) and their
//   first thread refills each stage as it is released;
// - the softmax, not the tensor cores, is the limit at d = 64 (an ex2, an
//   FMA, a max and an add a score against 2·d flops), so it is kept off
//   the tensor cores' path: within a warpgroup the softmax of tile j runs
//   while P·V of tile j - 1 is on the tensor cores (S_j and P_{j-1}·V_{j-1}
//   are issued back to back: FlashAttention-3's intra-warpgroup overlap),
//   and the two warpgroups interleave on their own (forcing them to take
//   turns, FlashAttention-3's ping-pong, gained nothing at the UNet's
//   sites and slowed small grids);
// - TMA copies Q once and K/V tiles into a ring of 2-3 stages with full and
//   empty mbarriers (hopper.cuh), so the loads of later tiles overlap the
//   math on this one and no thread spends registers or instructions on
//   addresses.  The maps are 3-D (h·d, s, b): heads are addressed by column
//   offset (no transpose, odd head counts need nothing), and rows past s of
//   a sample, and columns past h·d, read as zeros;
// - the head's d columns are split into 64-column chunks (128-byte swizzle)
//   and a 32- and/or 16-column tail (64- and 32-byte swizzle), so every
//   d % 16 == 0 from 16 to 256 maps onto swizzle atoms exactly;
// - scores stay in registers: the online softmax runs on the S
//   accumulators, which, rounded to bf16, are the register A operand of
//   P·V; V is read by wgmma as an MN-major operand straight from the TMA
//   tile (no transposed copy, no scalar loads);
// - the ragged K edge is masked on the last tile only; zero-filled K/V rows
//   past sk add nothing.
// Tiles: 128 keys a step for d ≤ 64, 64 above (the register budget of the
// 64 x d fp32 accumulator); stages as many as fit, at most 3.  One block a
// SM: two blocks of 64-key tiles fit at d = 64 and hid the setup of short
// sequences (s = 256), but were slower at s = 4096.
//
// Arithmetic: q is pre-scaled by 1/√d and rounded to bf16 before Q·Kᵀ (the
// consumers scale the TMA tile in place), as the TPU backward kernels round
// q̂, so that the stored lse matches the scores the backward rebuilds; the
// softmax then runs in the exp2 domain (scores × log2 e in fp32).  The TPU
// forward kernels differ by where log2 e goes: they fold it into the
// pre-scale (q·log2 e/√d, then rounded); a caller whose q is already
// pre-scaled that way (kernel 11, csrc/ln_qkv.cu) passes scale = 1 and
// exp2_scale = 1, and gets that arithmetic.  When autograd needs it, the
// kernel also stores each row's log-sum-exp in the exp2 domain,
// lse2 = m + log2(l), fp32 (b, heads, sq), so the backward kernels
// (flash_attention_bwd.cu) rebuild P = exp2(s·log2 e − lse2) in one pass.
#include "common.cuh"
#include "hopper.cuh"

namespace aat {
namespace {

using namespace hopper;

constexpr int BQ = 128;         // query rows per block
constexpr int CONSUMERS = 256;  // two warpgroups of 64 rows (and a producer warpgroup, see Layout)
// Registers a thread after setmaxnreg: 40·128 + 232·256 ≤ 65,536.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;

// The head's columns as swizzle chunks: d / 64 chunks of 64 columns, then
// one of 32 where d % 64 ≥ 32, then one of 16 where d % 32 == 16.  A tile
// of R rows stores chunk after chunk, each R rows x (width · 2) bytes.
template <int D>
struct Layout {
  static constexpr int N64 = D / 64;
  static constexpr bool H32 = D % 64 >= 32;
  static constexpr bool H16 = D % 32 == 16;
  static constexpr int CHUNKS = N64 + H32 + H16;
  static constexpr int BKV = D <= 64 ? 128 : 64;
  // A producer warpgroup where the consumers' accumulators fit the 168
  // registers a thread that ptxas allots in a 384-thread block; above, the
  // two consumer warpgroups alone (up to 255 registers), their first
  // thread issuing the loads between its tiles.
  static constexpr bool PRODUCER_WG = D <= 160;
  static constexpr int THREADS = CONSUMERS + (PRODUCER_WG ? 128 : 0);
  __host__ __device__ static constexpr int width(int i) {
    return i < N64 ? 64 : (i == N64 && H32) ? 32 : 16;
  }
  __host__ __device__ static constexpr int col(int i) {
    return i <= N64 ? 64 * i : 64 * N64 + 32;
  }
  __host__ __device__ static constexpr int kind(int i) {  // map index: 64, 32, 16 columns
    return width(i) == 64 ? 0 : width(i) == 32 ? 1 : 2;
  }
  __host__ __device__ static constexpr int offset(int i, int rows) {
    return rows * col(i) * 2;
  }
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? FIT : 3;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static_assert(STAGES >= 2, "K/V ring");
};

struct FwdParams {
  CUtensorMap q[3], k[3], v[3];  // by chunk width: 64, 32, 16 columns
  bf16* o;
  float* lse;
  int sq, sk, heads;
  float scale, exp2_scale;
};

// S = Q̂·Kᵀ for warpgroup wg's 64 rows of the Q tile at qt and one K tile
// at kt, over the chunks' k16 steps: issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qt, int wg, uint32_t kt) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < L::CHUNKS; ++i) {
    const int rb = 2 * L::width(i);
    const uint32_t qa = qt + L::offset(i, BQ) + wg * 64 * rb, ka = kt + L::offset(i, L::BKV);
#pragma unroll
    for (int kk = 0; kk < L::width(i) / 16; ++kk)
      wgmma_ss<L::BKV>(sc, desc_k_major(qa + 32 * kk, rb), desc_k_major(ka + 32 * kk, rb),
                       i + kk > 0);
  }
}

// O += P·V: P from registers (pa[kk], the A operand of k16 step kk), V (BKV x
// d, d along the row) read MN-major from the TMA tile: issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4], uint32_t vt) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < L::BKV / 16; ++kk)
#pragma unroll
    for (int i = 0; i < L::CHUNKS; ++i) {
      const int rb = 2 * L::width(i);
      const uint64_t dv = desc_mn_major(vt + L::offset(i, L::BKV) + 16 * kk * rb, rb);
      float* acc = o + L::col(i) / 2;
      if (L::width(i) == 64)
        wgmma_rs_tb<64>(acc, pa[kk], dv);
      else if (L::width(i) == 32)
        wgmma_rs_tb<32>(acc, pa[kk], dv);
      else
        wgmma_rs_tb<16>(acc, pa[kk], dv);
    }
}

// 2^x on the special-function unit alone (ex2.approx.ftz: a result below
// 2^-126 flushes to zero, where exp2f would return a subnormal).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one S tile in the exp2 domain (scores × exp2_scale),
// in place: sc becomes P in fp32; the running max and sum of the thread's
// two rows (g and g + 8 of its warp's 16) move on, alpha is the factor
// that rescales the rows' output accumulators.  Key columns at or past sk
// are masked (only the last tile has any).  The row max is taken of the
// raw scores and then scaled (rounding is monotonic, so it equals the max
// of the scaled scores), and p = 2^(s·exp2_scale − m) is one FMA and one
// ex2 a score.
template <int BKV>
__device__ __forceinline__ void softmax_tile(float* sc, float* m_run, float* l_run, float* alpha,
                                             int k0, int sk, float exp2_scale, int t) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (k0 + BKV > sk) {
#pragma unroll
    for (int x = 0; x < BKV / 2; ++x)
      if (k0 + 8 * (x >> 2) + 2 * t + (x & 1) >= sk) sc[x] = -CUDART_INF_F;
  }
#pragma unroll
  for (int x = 0; x < BKV / 2; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
  float rsum[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * exp2_scale);
    alpha[r] = exp2_ftz(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int x = 0; x < BKV / 2; ++x) {
    sc[x] = exp2_ftz(fmaf(sc[x], exp2_scale, neg_m[(x >> 1) & 1]));
    rsum[(x >> 1) & 1] += sc[x];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + rsum[r];
  }
}

// P (fp32 S accumulators) → bf16 A operands: n8 blocks 2kk and 2kk + 1 are
// k16 step kk.  And the output rows rescaled by alpha.
template <int D, int BKV>
__device__ __forceinline__ void pack_and_rescale(uint32_t (*pa)[4], const float* sc, float* o,
                                                 const float* alpha) {
#pragma unroll
  for (int n8 = 0; n8 < BKV / 8; ++n8) {
    pa[n8 / 2][2 * (n8 & 1)] = pack_bf16(sc[4 * n8], sc[4 * n8 + 1]);
    pa[n8 / 2][2 * (n8 & 1) + 1] = pack_bf16(sc[4 * n8 + 2], sc[4 * n8 + 3]);
  }
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
}

template <int N>
__device__ __forceinline__ void fence_all(float* r) {
#pragma unroll
  for (int x = 0; x < N; ++x) fence_operand(r[x]);
}

// Shared-memory map of one block: the Q tile, the K/V ring, the barriers
// (Q full; per stage K full, V full, empty).
template <int D>
struct Smem {
  using L = Layout<D>;
  uint32_t q, kv, q_full, k_full, v_full, empty;
  __device__ explicit Smem(uint32_t base)
      : q(base), kv(base + L::Q_BYTES),
        q_full(base + L::Q_BYTES + L::STAGES * L::STAGE_BYTES), k_full(q_full + 8),
        v_full(q_full + 8 * (1 + L::STAGES)), empty(q_full + 8 * (1 + 2 * L::STAGES)) {}
  __device__ uint32_t k_tile(int s) const { return kv + s * L::STAGE_BYTES; }
  __device__ uint32_t v_tile(int s) const { return kv + s * L::STAGE_BYTES + L::KV_BYTES; }
};

// TMA of the block's Q tile (one thread).
template <int D>
__device__ __forceinline__ void load_q(const FwdParams& p, const Smem<D>& sm, int c0, int q0,
                                       int bi) {
  using L = Layout<D>;
  mbar_expect_tx(sm.q_full, L::Q_BYTES);
#pragma unroll
  for (int i = 0; i < L::CHUNKS; ++i)
    tma_load_3d(sm.q + L::offset(i, BQ), &p.q[L::kind(i)], sm.q_full, c0 + L::col(i), q0, bi);
}

// TMA of K/V tile j into its stage, once the consumers have released the
// stage's previous tile (one thread).
template <int D>
__device__ __forceinline__ void load_kv(const FwdParams& p, const Smem<D>& sm, int j, int c0,
                                        int bi) {
  using L = Layout<D>;
  const int s = j % L::STAGES;
  const uint32_t kf = sm.k_full + 8 * s, vf = sm.v_full + 8 * s;
  mbar_wait(sm.empty + 8 * s, ((j / L::STAGES) & 1) ^ 1);
  mbar_expect_tx(kf, L::KV_BYTES);
#pragma unroll
  for (int i = 0; i < L::CHUNKS; ++i)
    tma_load_3d(sm.k_tile(s) + L::offset(i, L::BKV), &p.k[L::kind(i)], kf, c0 + L::col(i),
                j * L::BKV, bi);
  mbar_expect_tx(vf, L::KV_BYTES);
#pragma unroll
  for (int i = 0; i < L::CHUNKS; ++i)
    tma_load_3d(sm.v_tile(s) + L::offset(i, L::BKV), &p.v[L::kind(i)], vf, c0 + L::col(i),
                j * L::BKV, bi);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ FwdParams p) {
  using L = Layout<D>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES, NC = L::CHUNKS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte bases
  uint8_t* q_tile = smem_raw + (base - raw);
  const Smem<D> sm(base);

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / p.heads, hi = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * BQ, c0 = hi * D;
  const int nk = (p.sk + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.k_full + 8 * s, 1);
      mbar_init(sm.v_full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (L::PRODUCER_WG && tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full ---------------
    if constexpr (L::PRODUCER_WG) setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      load_q<D>(p, sm, c0, q0, bi);
      for (int j = 0; j < nk; ++j) load_kv<D>(p, sm, j, c0, bi);
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [64·wg, 64·wg + 64) -------
    if constexpr (L::PRODUCER_WG) {
      setmaxnreg_inc<CONSUMER_REGS>();
    } else {
      if (tid == 0) {  // the first STAGES tiles; the rest as stages free up
        load_q<D>(p, sm, c0, q0, bi);
        for (int j = 0; j < nk && j < STAGES; ++j) load_kv<D>(p, sm, j, c0, bi);
      }
      __syncwarp();
    }
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
    const int t = lane & 3;

    mbar_wait(sm.q_full, 0);
    if (p.scale != 1.f) {
      // q̂ = bf16(q · scale), in place over this warpgroup's rows of each chunk
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int rb = 2 * L::width(i);
        uint4* rows = reinterpret_cast<uint4*>(q_tile + L::offset(i, BQ) + wg * 64 * rb);
        for (int u = tid % 128; u < 64 * rb / 16; u += 128) {
          uint4 val = rows[u];
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float2 f = __bfloat1622float2(e[x]);
            e[x] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
          }
          rows[u] = val;
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
    }

    float o[D / 2], sc[BKV / 2];
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f}, alpha[2];

    // Tile 0's scores, then per tile j ≥ 1: issue S_j = Q̂·K_jᵀ and O += P_{j-1}·V_{j-1}
    // back to back, run the softmax of S_j while P_{j-1}·V_{j-1} is on the
    // tensor cores, and release stage j - 1 once that product is done.
    mbar_wait(sm.k_full, 0);
    fence_all<BKV / 2>(sc);
    wgmma_fence();
    issue_qk<D>(sc, sm.q, wg, sm.k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all<BKV / 2>(sc);
    softmax_tile<BKV>(sc, m_run, l_run, alpha, 0, p.sk, p.exp2_scale, t);
    pack_and_rescale<D, BKV>(pa, sc, o, alpha);
    for (int j = 1; j < nk; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      mbar_wait(sm.k_full + 8 * s, (j / STAGES) & 1);
      fence_all<BKV / 2>(sc);
      fence_all<D / 2>(o);
      wgmma_fence();
      issue_qk<D>(sc, sm.q, wg, sm.k_tile(s));
      wgmma_commit();
      mbar_wait(sm.v_full + 8 * sp, ((j - 1) / STAGES) & 1);
      issue_pv<D>(o, pa, sm.v_tile(sp));
      wgmma_commit();
      wgmma_wait<1>();  // S_j is in; P_{j-1}·V_{j-1} may still run
      fence_all<BKV / 2>(sc);
      softmax_tile<BKV>(sc, m_run, l_run, alpha, j * BKV, p.sk, p.exp2_scale, t);
      wgmma_wait<0>();
      fence_all<D / 2>(o);
      mbar_arrive(sm.empty + 8 * sp);
      if constexpr (!L::PRODUCER_WG) {
        if (tid == 0 && j - 1 + STAGES < nk)
          load_kv<D>(p, sm, j - 1 + STAGES, c0, bi);  // refill the stage just released
        __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
      }
      pack_and_rescale<D, BKV>(pa, sc, o, alpha);
    }
    const int sl = (nk - 1) % STAGES;
    mbar_wait(sm.v_full + 8 * sl, ((nk - 1) / STAGES) & 1);
    fence_all<D / 2>(o);
    wgmma_fence();
    issue_pv<D>(o, pa, sm.v_tile(sl));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all<D / 2>(o);
    mbar_arrive(sm.empty + 8 * sl);

    const int C = p.heads * D;
    const int row_a = q0 + wg * 64 + warp * 16 + (lane >> 2), row_b = row_a + 8;
    const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
    if (p.lse != nullptr && t == 0) {
      float* lb = p.lse + (size_t)blockIdx.y * p.sq;
      if (row_a < p.sq) lb[row_a] = m_run[0] + log2f(l_run[0]);
      if (row_b < p.sq) lb[row_b] = m_run[1] + log2f(l_run[1]);
    }
    bf16* ob = p.o + (size_t)bi * p.sq * C + hi * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const int col = 8 * n8 + 2 * t;
      if (row_a < p.sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * C + col) =
            pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
      if (row_b < p.sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * C + col) =
            pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int sk, int heads, float scale, float exp2_scale, cudaStream_t stream) {
  using L = Layout<D>;
  FwdParams p = {};
  const uint64_t C = static_cast<uint64_t>(heads) * D;
  const bool used[3] = {L::N64 > 0, L::H32, L::H16};
  for (int kind = 0; kind < 3; ++kind) {
    if (!used[kind]) continue;
    const uint32_t w = 64 >> kind;
    int err = make_map_3d(&p.q[kind], q, C, sq, b, w, BQ);
    if (!err) err = make_map_3d(&p.k[kind], k, C, sk, b, w, L::BKV);
    if (!err) err = make_map_3d(&p.v[kind], v, C, sk, b, w, L::BKV);
    if (err) return static_cast<int>(cudaErrorInvalidValue);
  }
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.scale = scale;
  p.exp2_scale = exp2_scale;
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  dim3 grid((sq + BQ - 1) / BQ, b * heads);
  flash_fwd_wgmma_kernel<D><<<grid, L::THREADS, L::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// q, o: (b, sq, heads·d); k, v: (b, sk, heads·d); all contiguous bf16, 16-byte
// aligned; d % 16 == 0, 16 ≤ d ≤ 256.
// lse: null, or fp32 (b, heads, sq) for the row log-sum-exp (log2 domain).
// scale: the pre-scale of q (1/√d); exp2_scale: the factor that takes the
// scores to the exp2 domain (log2 e; 1 when q was pre-scaled by log2 e/√d).
AAT_EXPORT int aat_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int b, int sq, int sk, int heads, int d,
                                   float scale, float exp2_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (b < 1 || sq < 1 || sk < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
#define AAT_FLASH_CASE(D) \
  case D: return aat::launch<D>(q, k, v, o, l, b, sq, sk, heads, scale, exp2_scale, st);
  switch (d) {
    AAT_FLASH_CASE(16) AAT_FLASH_CASE(32) AAT_FLASH_CASE(48) AAT_FLASH_CASE(64)
    AAT_FLASH_CASE(80) AAT_FLASH_CASE(96) AAT_FLASH_CASE(112) AAT_FLASH_CASE(128)
    AAT_FLASH_CASE(144) AAT_FLASH_CASE(160) AAT_FLASH_CASE(176) AAT_FLASH_CASE(192)
    AAT_FLASH_CASE(208) AAT_FLASH_CASE(224) AAT_FLASH_CASE(240) AAT_FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AAT_FLASH_CASE
}
