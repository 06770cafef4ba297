// Flash attention backward (dq; dk, dv) on the natural (b, s, h·d)
// projection layout, non-causal, every d % 16 == 0 from 16 to 256, on TMA
// and wgmma.
//
// Replaces animate_anything_tpu/ops/flash_attention.py::_flash_backward_lanes
// (d = 64; _bwd_dq_lanes_kernel, _bwd_dkv_lanes_kernel) and ::_flash_backward
// (other head sizes; _bwd_dq_kernel, _bwd_dkv_kernel).  As in the forward,
// heads are addressed by column offset inside the (b, s, h·d) rows: no head
// transpose, and odd head counts need no pairing.
//
// Bound on the H100: tensor-core math.  Per head the backward does five
// s_q x s_k x d products (recompute S, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K,
// dK = dSᵀ·Q̂), 10·sq·sk·d flops against ~16·s·d bytes of q, k, v, o, dO,
// dq, dk, dv.  What the design does about it (the forward's building
// blocks, csrc/hopper.cuh):
// - two kernels, dq and then dk/dv, and no atomics, so the gradients are
//   deterministic, bit for bit from run to run.  S and dP are rebuilt in
//   both, seven products where the bound counts five: the split's ceiling
//   is 5/7 of the bound's rate;
// - two consumer warpgroups of 64 rows issue every product as wgmma, and a
//   producer warp keeps TMA loads over the 3-D (h·d, s, b) maps in flight
//   on full/empty mbarrier rings.  A 288-thread block leaves a thread 168
//   registers (three warps share a sub-partition's register file, as in
//   the forward's 384-thread blocks); where the accumulators need more
//   (dq above d = 80, dk/dv above d = 208) the block is the two
//   warpgroups alone (255 registers), thread 0 refilling each released
//   stage, as the forward does above d = 160;
// - S, P, dP and dS never leave registers: the accumulators of S and dP
//   become P and dS in place and, rounded to bf16, are the register A
//   operands of the next products; the B operands are the TMA tiles as
//   they land, K-major for the score products, MN-major (the transpose
//   bit) for the gradient products;
// - dq: a block owns 128 query rows of one (sample, head) with Q̂ and dO
//   resident and runs a ring over K/V tiles: S = Q̂·Kᵀ, dP = dO·Vᵀ, P =
//   ex2(S·log2 e − lse2) from the forward's stored lse2 (no second pass
//   over K for the row max and sum; the TPU kernel holds a whole K row in
//   VMEM for that), dS = P ⊙ (dP − Δ), dQ += dS·K.  S_j and dP_j are issued
//   beside dQ += dS_{j−1}·K_{j−1}, as the forward overlaps P·V.  It also
//   computes Δ = rowsum(dO ⊙ O) in fp32 for its rows; it stores lse2 and Δ
//   side by side per (sample, head), padded to 64 rows (+inf and 0), and
//   writes Q̂ back out by TMA, for the second kernel;
// - dk/dv: a block owns a key tile with K and V resident and runs a ring
//   over Q̂, dO, lse2 and Δ tiles, all four as bulk copies on one mbarrier,
//   so the producer thread never waits on a load: Sᵀ = K·Q̂ᵀ, dPᵀ = V·dOᵀ,
//   dV += Pᵀ·dO, dK += dSᵀ·Q̂.  The loop replaces the TPU's sequential
//   "arbitrary" grid axis over q chunks.  Up to d = 64 each warpgroup owns
//   64 keys and both accumulators; above, dK and dV together (d fp32
//   registers a thread) do not fit, so the block owns 64 keys, warpgroup 0
//   accumulates dV and warpgroup 1 dK, each rebuilding Sᵀ (one product
//   more at those head sizes);
// - tiles by head size, so the accumulators fit the registers and the
//   rings 227 KB: 64 keys a dq step up to d = 112, 32 above; 64 queries a
//   dk/dv step up to d = 128, 32 above.
//
// Arithmetic of the TPU kernels: q is pre-scaled by 1/√d and rounded to bf16
// (Q̂) before Q̂·Kᵀ; p = exp2(s·log2 e − lse2); ds = p ⊙ (dp − Δ); ds is
// rounded to bf16 before dq = ds·K·(1/√d) and dk = dsᵀ·Q̂; p is rounded to
// bf16 before dv = pᵀ·dO.  Ragged edges: key columns past sk get p = 0 in
// the dq pass (their K and V rows read as zeros through the maps); query
// rows past sq read as zeros through the maps with lse = +inf, so p = 0 and
// dO = 0 there and they add nothing to dk, dv.
#include "common.cuh"
#include "hopper.cuh"

namespace aat {
namespace {

using namespace hopper;

constexpr int CONSUMERS = 256;  // two warpgroups (and, where the registers allow, a producer warp)
constexpr int SMEM_LIMIT = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// ---- products over the head's chunks -----------------------------------------

// acc (64 x N) = A·Bᵀ over d: A is rows [a_row0, a_row0 + 64) of a tile of
// A_ROWS rows, B a tile of N rows, both with d along the row (K-major).
// Issued, not waited for.
template <int D, int A_ROWS, int N>
__device__ __forceinline__ void issue_ss(float* acc, uint32_t a, int a_row0, uint32_t b) {
  using H = HeadChunks<D>;
#pragma unroll
  for (int i = 0; i < H::COUNT; ++i) {
    const int rb = 2 * H::width(i);
    const uint32_t aa = a + H::offset(i, A_ROWS) + a_row0 * rb, ba = b + H::offset(i, N);
#pragma unroll
    for (int kk = 0; kk < H::width(i) / 16; ++kk)
      wgmma_ss<N>(acc, desc_k_major(aa + 32 * kk, rb), desc_k_major(ba + 32 * kk, rb), i + kk > 0);
  }
}

// acc (64 x d) += A·B: A from registers (a[kk], the operand of k16 step kk),
// B a tile of K_ROWS rows with d along the row, read MN-major.  Issued, not
// waited for.
template <int D, int K_ROWS>
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t (*a)[4], uint32_t b) {
  using H = HeadChunks<D>;
#pragma unroll
  for (int kk = 0; kk < K_ROWS / 16; ++kk)
#pragma unroll
    for (int i = 0; i < H::COUNT; ++i) {
      const int rb = 2 * H::width(i);
      const uint64_t db = desc_mn_major(b + H::offset(i, K_ROWS) + 16 * kk * rb, rb);
      float* part = acc + H::col(i) / 2;
      if (H::width(i) == 64)
        wgmma_rs_tb<64>(part, a[kk], db);
      else if (H::width(i) == 32)
        wgmma_rs_tb<32>(part, a[kk], db);
      else
        wgmma_rs_tb<16>(part, a[kk], db);
    }
}

// fp32 accumulators (64 x N) → bf16 A operands: n8 blocks 2kk and 2kk + 1
// are k16 step kk.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* acc) {
#pragma unroll
  for (int n8 = 0; n8 < N / 8; ++n8) {
    a[n8 / 2][2 * (n8 & 1)] = pack_bf16(acc[4 * n8], acc[4 * n8 + 1]);
    a[n8 / 2][2 * (n8 & 1) + 1] = pack_bf16(acc[4 * n8 + 2], acc[4 * n8 + 3]);
  }
}

// The thread's rows row_a and row_b (< rows) of a 64 x D accumulator, times
// scale, to bf16 rows of stride C.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float* acc, int row_a, int row_b,
                                           int rows, int C, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = 8 * n8 + 2 * t;
    if (row_a < rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_a * C + col) =
          pack_bf16(acc[4 * n8] * scale, acc[4 * n8 + 1] * scale);
    if (row_b < rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_b * C + col) =
          pack_bf16(acc[4 * n8 + 2] * scale, acc[4 * n8 + 3] * scale);
  }
}

// Box rows of one chunk of a TMA tile from a map per chunk width.
template <int D>
__device__ __forceinline__ void load_chunks(uint32_t dst, int rows, const CUtensorMap* maps,
                                            uint32_t bar, int c0, int row0, int bi) {
  using H = HeadChunks<D>;
#pragma unroll
  for (int i = 0; i < H::COUNT; ++i)
    tma_load_3d(dst + H::offset(i, rows), &maps[H::kind(i)], bar, c0 + H::col(i), row0, bi);
}

// ---- dq -------------------------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr int BQ = 128;  // query rows a block: 64 a consumer warpgroup
  static constexpr int BKV = D <= 112 ? 64 : 32;
  static constexpr int Q_BYTES = BQ * D * 2;  // the Q̂ tile; the dO tile the same
  static constexpr int KV_BYTES = BKV * D * 2;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256 - 2 * Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? FIT : 3;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 3 * STAGES);
  // A producer warp where the consumers fit the 168 registers a thread of a
  // 288-thread block (one sub-partition's register file shared by three
  // warps); above, the two warpgroups alone (255), thread 0 issuing the loads.
  static constexpr bool PRODUCER = D <= 80;
  static constexpr int THREADS = CONSUMERS + (PRODUCER ? 32 : 0);
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static_assert(STAGES >= 2, "K/V ring");
};

struct DqParams {
  // By chunk width (64, 32, 16 columns); box rows BQ, BQ, BKV, BKV and 64
  // (one warpgroup's rows of the Q̂ tile, stored).
  CUtensorMap q[3], dout[3], k[3], v[3], qhat[3];
  const bf16* o;
  const bf16* dout_rows;
  const float* lse;
  float* rows;  // per (sample, head): lse2 of sq_pad rows, then Δ
  bf16* dq;
  int sq, sq_pad, sk, heads;
  float scale;
};

// dS = P ⊙ (dP − Δ) in place of S, P = 2^(s·log2 e − lse2); key columns at
// or past sk (only on the last tile) get P = 0.
template <int BKV>
__device__ __forceinline__ void ds_tile(float* sc, const float* dp, const float* l2,
                                        const float* dl, int k0, int sk, int t) {
  const bool ragged = k0 + BKV > sk;
#pragma unroll
  for (int x = 0; x < BKV / 2; ++x) {
    const int r = (x >> 1) & 1;
    float pv = exp2_ftz(fmaf(sc[x], kLog2e, -l2[r]));
    if (ragged && k0 + 8 * (x >> 2) + 2 * t + (x & 1) >= sk) pv = 0.f;
    sc[x] = pv * (dp[x] - dl[r]);
  }
}

// Shared-memory addresses of a dq block.
struct DqSmem {
  uint32_t q, dout, ring, q_full, k_full, v_full, empty;
};

// TMA of K/V tile j into its stage once the consumers have released the
// stage's previous tile (one thread).
template <int D>
__device__ __forceinline__ void dq_load_kv(const DqParams& p, const DqSmem& sm, int j, int c0,
                                           int bi) {
  using L = DqLayout<D>;
  const int s = j % L::STAGES;
  const uint32_t kt = sm.ring + s * L::STAGE_BYTES;
  mbar_wait(sm.empty + 8 * s, ((j / L::STAGES) & 1) ^ 1);
  mbar_expect_tx(sm.k_full + 8 * s, L::KV_BYTES);
  load_chunks<D>(kt, L::BKV, p.k, sm.k_full + 8 * s, c0, j * L::BKV, bi);
  mbar_expect_tx(sm.v_full + 8 * s, L::KV_BYTES);
  load_chunks<D>(kt + L::KV_BYTES, L::BKV, p.v, sm.v_full + 8 * s, c0, j * L::BKV, bi);
}

// TMA of the block's Q and dO tiles, then of the first `tiles` K/V tiles
// (one thread).
template <int D>
__device__ __forceinline__ void dq_load_first(const DqParams& p, const DqSmem& sm, int tiles,
                                              int c0, int q0, int bi) {
  using L = DqLayout<D>;
  mbar_expect_tx(sm.q_full, 2 * L::Q_BYTES);
  load_chunks<D>(sm.q, L::BQ, p.q, sm.q_full, c0, q0, bi);
  load_chunks<D>(sm.dout, L::BQ, p.dout, sm.q_full, c0, q0, bi);
  for (int j = 0; j < tiles; ++j) dq_load_kv<D>(p, sm, j, c0, bi);
}

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  using L = DqLayout<D>;
  using H = HeadChunks<D>;
  constexpr int BQ = L::BQ, BKV = L::BKV, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte bases
  uint8_t* q_bytes = smem_raw + (base - raw);
  const uint32_t q_tile = base, do_tile = base + L::Q_BYTES, ring = base + 2 * L::Q_BYTES;
  const uint32_t q_full = ring + STAGES * L::STAGE_BYTES, k_full = q_full + 8,
                 v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;
  const DqSmem sm = {q_tile, do_tile, ring, q_full, k_full, v_full, empty};

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / p.heads, hi = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * BQ, c0 = hi * D;
  const int nk = (p.sk + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if constexpr (L::PRODUCER) {
    if (tid >= CONSUMERS) {
      // ---- producer warp: one thread loads Q and dO, then keeps the ring full
      if (tid == CONSUMERS) dq_load_first<D>(p, sm, nk, c0, q0, bi);
      return;
    }
  } else {
    if (tid == 0) dq_load_first<D>(p, sm, nk < STAGES ? nk : STAGES, c0, q0, bi);
    __syncwarp();
  }

  // ---- consumers: warpgroup wg owns query rows [64·wg, 64·wg + 64) ---------
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int t = lane & 3;
  const int C = p.heads * D;
  const int row_a = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int qrow[2] = {row_a, row_a + 8};
  const size_t bh = blockIdx.y, head_off = (size_t)bi * p.sq * C + c0;

  // Δ = rowsum(dO ⊙ O) in fp32 for the thread's two rows (the row's four
  // threads take its 16-byte chunks in turn), and the rows' lse2; both out
  // for the dk/dv kernel, +inf and 0 on its padding rows.
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float acc = 0.f;
    if (qrow[r] < p.sq) {
      const bf16* dor = p.dout_rows + head_off + (size_t)qrow[r] * C;
      const bf16* orow = p.o + head_off + (size_t)qrow[r] * C;
      for (int c8 = t; c8 < D / 8; c8 += 4) {
        const uint4 a = *reinterpret_cast<const uint4*>(dor + 8 * c8);
        const uint4 b = *reinterpret_cast<const uint4*>(orow + 8 * c8);
        const __nv_bfloat162* ea = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* eb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 fa = __bfloat1622float2(ea[x]), fb = __bfloat1622float2(eb[x]);
          acc = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    l2[r] = qrow[r] < p.sq ? p.lse[bh * p.sq + qrow[r]] : CUDART_INF_F;
    if (t == 0 && qrow[r] < p.sq_pad) {
      p.rows[2 * bh * p.sq_pad + qrow[r]] = l2[r];
      p.rows[(2 * bh + 1) * p.sq_pad + qrow[r]] = acc;
    }
  }

  // q̂ = bf16(q · scale), in place over this warpgroup's rows of each chunk;
  // then out to qhat for the dk/dv kernel (rows past sq are not written).
  mbar_wait(q_full, 0);
#pragma unroll
  for (int i = 0; i < H::COUNT; ++i) {
    const int rb = 2 * H::width(i);
    uint4* tile = reinterpret_cast<uint4*>(q_bytes + H::offset(i, BQ) + wg * 64 * rb);
    for (int u = tid % 128; u < 64 * rb / 16; u += 128) {
      uint4 val = tile[u];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 f = __bfloat1622float2(e[x]);
        e[x] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
      }
      tile[u] = val;
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
  const bool stores_qhat = tid % 128 == 0 && q0 + wg * 64 < p.sq;
  if (stores_qhat) {
#pragma unroll
    for (int i = 0; i < H::COUNT; ++i)
      tma_store_3d(&p.qhat[H::kind(i)], q_tile + H::offset(i, BQ) + wg * 64 * 2 * H::width(i),
                   c0 + H::col(i), q0 + wg * 64, bi);
    bulk_commit();
  }

  float dq[D / 2], sc[BKV / 2], dp[BKV / 2];
  uint32_t da[BKV / 16][4];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
  auto k_tile = [&](int s) { return ring + s * L::STAGE_BYTES; };

  // Tile 0's S and dP, then per tile j ≥ 1: issue S_j, dP_j and
  // dQ += dS_{j−1}·K_{j−1} back to back, build dS_j while that product is on
  // the tensor cores, and release stage j − 1 once it is done.
  mbar_wait(k_full, 0);
  mbar_wait(v_full, 0);
  fence_all<BKV / 2>(sc);
  fence_all<BKV / 2>(dp);
  wgmma_fence();
  issue_ss<D, BQ, BKV>(sc, q_tile, wg * 64, k_tile(0));
  issue_ss<D, BQ, BKV>(dp, do_tile, wg * 64, k_tile(0) + L::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<BKV / 2>(sc);
  fence_all<BKV / 2>(dp);
  ds_tile<BKV>(sc, dp, l2, dl, 0, p.sk, t);
  pack_a<BKV>(da, sc);
  for (int j = 1; j < nk; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    mbar_wait(k_full + 8 * s, (j / STAGES) & 1);
    mbar_wait(v_full + 8 * s, (j / STAGES) & 1);
    fence_all<BKV / 2>(sc);
    fence_all<BKV / 2>(dp);
    fence_all<D / 2>(dq);
    wgmma_fence();
    issue_ss<D, BQ, BKV>(sc, q_tile, wg * 64, k_tile(s));
    issue_ss<D, BQ, BKV>(dp, do_tile, wg * 64, k_tile(s) + L::KV_BYTES);
    wgmma_commit();
    issue_rs<D, BKV>(dq, da, k_tile(sp));
    wgmma_commit();
    wgmma_wait<1>();  // S_j and dP_j are in; dQ += dS_{j−1}·K_{j−1} may still run
    fence_all<BKV / 2>(sc);
    fence_all<BKV / 2>(dp);
    ds_tile<BKV>(sc, dp, l2, dl, j * BKV, p.sk, t);
    wgmma_wait<0>();
    fence_all<D / 2>(dq);
    mbar_arrive(empty + 8 * sp);
    if constexpr (!L::PRODUCER) {
      if (tid == 0 && j - 1 + STAGES < nk)
        dq_load_kv<D>(p, sm, j - 1 + STAGES, c0, bi);  // refill the stage just released
      __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
    }
    pack_a<BKV>(da, sc);
  }
  const int sl = (nk - 1) % STAGES;
  fence_all<D / 2>(dq);
  wgmma_fence();
  issue_rs<D, BKV>(dq, da, k_tile(sl));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<D / 2>(dq);
  mbar_arrive(empty + 8 * sl);

  store_rows<D>(p.dq + head_off, dq, qrow[0], qrow[1], p.sq, C, p.scale);
  if (stores_qhat) bulk_wait_read();  // the Q̂ tile stays until the store has read it
}

// ---- dk/dv ----------------------------------------------------------------------

template <int D>
struct DkvLayout {
  // Above d = 64 one warpgroup cannot hold both 64 x d accumulators: the
  // block owns 64 keys, warpgroup 0 accumulates dV, warpgroup 1 dK.
  static constexpr bool SPLIT = D > 64;
  static constexpr int KEYS = SPLIT ? 64 : 128;  // keys a block
  static constexpr int BQ = D <= 128 ? 64 : 32;  // queries a ring step
  static constexpr int KV_BYTES = KEYS * D * 2;  // one of K, V
  static constexpr int Q_BYTES = BQ * D * 2;     // one of Q̂, dO
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  static constexpr int ROW_FLOATS = 2 * BQ;  // lse2 and Δ of a stage's rows
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - 256 - 2 * KV_BYTES) / (STAGE_BYTES + 4 * ROW_FLOATS);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int ROWS_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 4 * ROW_FLOATS;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
  // A producer warp where the consumers fit 168 registers (see DqLayout).
  static constexpr bool PRODUCER = D <= 208;
  static constexpr int THREADS = CONSUMERS + (PRODUCER ? 32 : 0);
  static_assert(STAGES >= 2, "Q̂/dO ring");
};

struct DkvParams {
  // By chunk width; box rows BQ, BQ, KEYS, KEYS.
  CUtensorMap qhat[3], dout[3], k[3], v[3];
  const float* rows;  // the dq kernel's lse2 and Δ rows
  bf16* dk;
  bf16* dv;
  int sq, sq_pad, sk, heads;
};

// Shared-memory addresses of a dk/dv block.
struct DkvSmem {
  uint32_t k, v, ring, kv_full, q_full, empty;
  const float* rows;  // per stage: lse2 of its BQ rows, then Δ
};

// Q̂, dO, lse2 and Δ of q tile j into its stage, as TMA and bulk copies on
// one barrier, once the consumers have released the stage (one thread).
template <int D>
__device__ __forceinline__ void dkv_load_q(const DkvParams& p, const DkvSmem& sm, int j, int c0,
                                           int bi) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ;
  const int s = j % L::STAGES;
  const uint32_t qt = sm.ring + s * L::STAGE_BYTES, bar = sm.q_full + 8 * s;
  const uint32_t ls = smem_u32(sm.rows + s * L::ROW_FLOATS);
  const float* rows = p.rows + 2 * (size_t)blockIdx.y * p.sq_pad + j * BQ;
  mbar_wait(sm.empty + 8 * s, ((j / L::STAGES) & 1) ^ 1);
  mbar_expect_tx(bar, 2 * L::Q_BYTES + 8 * BQ);
  load_chunks<D>(qt, BQ, p.qhat, bar, c0, j * BQ, bi);
  load_chunks<D>(qt + L::Q_BYTES, BQ, p.dout, bar, c0, j * BQ, bi);
  bulk_load(ls, rows, 4 * BQ, bar);
  bulk_load(ls + 4 * BQ, rows + p.sq_pad, 4 * BQ, bar);
}

// K and V of the block's keys, then the first `tiles` q tiles (one thread).
template <int D>
__device__ __forceinline__ void dkv_load_first(const DkvParams& p, const DkvSmem& sm, int tiles,
                                               int k0, int c0, int bi) {
  using L = DkvLayout<D>;
  mbar_expect_tx(sm.kv_full, 2 * L::KV_BYTES);
  load_chunks<D>(sm.k, L::KEYS, p.k, sm.kv_full, c0, k0, bi);
  load_chunks<D>(sm.v, L::KEYS, p.v, sm.kv_full, c0, k0, bi);
  for (int j = 0; j < tiles; ++j) dkv_load_q<D>(p, sm, j, c0, bi);
}

// Sᵀ = K·Q̂ᵀ (and dPᵀ = V·dOᵀ for DK) of one q tile at `qt` for the 64 keys
// at rows krow.. of the K/V tiles: issued, not waited for.
template <int D, bool DK>
__device__ __forceinline__ void issue_scores(float* st, float* dpt, const DkvSmem& sm, int krow,
                                             uint32_t qt) {
  using L = DkvLayout<D>;
  issue_ss<D, L::KEYS, L::BQ>(st, sm.k, krow, qt);
  if constexpr (DK) issue_ss<D, L::KEYS, L::BQ>(dpt, sm.v, krow, qt + L::Q_BYTES);
}

// Pᵀ in place of Sᵀ and, for DK, dSᵀ = Pᵀ ⊙ (dPᵀ − Δ) in place of dPᵀ:
// column q of the tile is query q of the stage's lse2 / Δ rows `ls`.
template <int BQ, bool DK>
__device__ __forceinline__ void p_ds_tile(float* st, float* dpt, const float* ls, int t) {
#pragma unroll
  for (int x = 0; x < BQ / 2; ++x) {
    const int qc = 8 * (x >> 2) + 2 * t + (x & 1);
    const float pv = exp2_ftz(fmaf(st[x], kLog2e, -ls[qc]));
    st[x] = pv;
    if constexpr (DK) dpt[x] = pv * (dpt[x] - ls[BQ + qc]);
  }
}

// One consumer warpgroup over every q tile, for its 64 keys (rows krow.. of
// the K/V tiles): Sᵀ, then dV += Pᵀ·dO (DV) and / or dPᵀ, dSᵀ and
// dK += dSᵀ·Q̂ (DK), in turn.  (Issuing the scores of tile j beside the
// gradient products of tile j − 1, as the dq kernel does, needs both sets
// of operands live: at d = 64 that spilled and was slower on the H100.)
template <int D, bool DV, bool DK>
__device__ __forceinline__ void consume_dkv(const DkvParams& p, const DkvSmem& sm, int krow,
                                            int k0, int nq, int bi, int c0) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x & 31, t = lane & 3;
  float dv[DV ? D / 2 : 1], dk[DK ? D / 2 : 1];
  float st[BQ / 2], dpt[DK ? BQ / 2 : 1];
  uint32_t pa[DV ? BQ / 16 : 1][4], da[DK ? BQ / 16 : 1][4];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) {
    if constexpr (DV) dv[x] = 0.f;
    if constexpr (DK) dk[x] = 0.f;
  }
  mbar_wait(sm.kv_full, 0);
  for (int j = 0; j < nq; ++j) {
    const int s = j % STAGES;
    const uint32_t qt = sm.ring + s * L::STAGE_BYTES;
    mbar_wait(sm.q_full + 8 * s, (j / STAGES) & 1);
    fence_all<BQ / 2>(st);
    if constexpr (DK) fence_all<BQ / 2>(dpt);
    wgmma_fence();
    issue_scores<D, DK>(st, dpt, sm, krow, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all<BQ / 2>(st);
    if constexpr (DK) fence_all<BQ / 2>(dpt);
    p_ds_tile<BQ, DK>(st, dpt, sm.rows + s * L::ROW_FLOATS, t);
    if constexpr (DV) {
      pack_a<BQ>(pa, st);
      fence_all<D / 2>(dv);
    }
    if constexpr (DK) {
      pack_a<BQ>(da, dpt);
      fence_all<D / 2>(dk);
    }
    wgmma_fence();
    if constexpr (DV) issue_rs<D, BQ>(dv, pa, qt + L::Q_BYTES);
    if constexpr (DK) issue_rs<D, BQ>(dk, da, qt);
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DV) fence_all<D / 2>(dv);
    if constexpr (DK) fence_all<D / 2>(dk);
    mbar_arrive(sm.empty + 8 * s);
    if constexpr (!L::PRODUCER) {
      if (threadIdx.x == 0 && j + STAGES < nq)
        dkv_load_q<D>(p, sm, j + STAGES, c0, bi);  // refill the stage just released
      __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
    }
  }

  const int C = p.heads * D;
  const int key_a = k0 + krow + warp * 16 + (lane >> 2);
  const size_t off = (size_t)bi * p.sk * C + c0;
  if constexpr (DV) store_rows<D>(p.dv + off, dv, key_a, key_a + 8, p.sk, C, 1.f);
  if constexpr (DK) store_rows<D>(p.dk + off, dk, key_a, key_a + 8, p.sk, C, 1.f);
}

template <int D>
__global__ void __launch_bounds__(DkvLayout<D>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ, KEYS = L::KEYS, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::ROWS_OFF);
  DkvSmem sm;
  sm.k = base;
  sm.v = base + L::KV_BYTES;
  sm.ring = base + 2 * L::KV_BYTES;
  sm.kv_full = base + L::BAR_OFF;
  sm.q_full = sm.kv_full + 8;
  sm.empty = sm.q_full + 8 * STAGES;
  sm.rows = rows;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y / p.heads, hi = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * KEYS, c0 = hi * D;
  const int nq = (p.sq + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.q_full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if constexpr (L::PRODUCER) {
    if (tid >= CONSUMERS) {
      // ---- producer warp: one thread loads K and V once, then keeps the
      // ring of Q̂, dO, lse2 and Δ tiles full ---------------------------------
      if (tid == CONSUMERS) dkv_load_first<D>(p, sm, nq, k0, c0, bi);
      return;
    }
  } else {
    if (tid == 0) dkv_load_first<D>(p, sm, nq < STAGES ? nq : STAGES, k0, c0, bi);
    __syncwarp();
  }

  const int wg = tid / 128;
  if constexpr (L::SPLIT) {
    if (wg == 0)
      consume_dkv<D, true, false>(p, sm, 0, k0, nq, bi, c0);
    else
      consume_dkv<D, false, true>(p, sm, 0, k0, nq, bi, c0);
  } else {
    consume_dkv<D, true, true>(p, sm, 64 * wg, k0, nq, bi, c0);
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* rows, void* qhat, void* dq, void* dk, void* dv, int b,
               int sq, int sk, int heads, float scale, cudaStream_t stream) {
  using H = HeadChunks<D>;
  using LQ = DqLayout<D>;
  using LK = DkvLayout<D>;
  DqParams pq = {};
  DkvParams pk = {};
  const uint64_t C = static_cast<uint64_t>(heads) * D;
  const bool used[3] = {H::N64 > 0, H::H32, H::H16};
  for (int kind = 0; kind < 3; ++kind) {
    if (!used[kind]) continue;
    const uint32_t w = 64 >> kind;
    int err = make_map_3d(&pq.q[kind], q, C, sq, b, w, LQ::BQ);
    if (!err) err = make_map_3d(&pq.dout[kind], dout, C, sq, b, w, LQ::BQ);
    if (!err) err = make_map_3d(&pq.k[kind], k, C, sk, b, w, LQ::BKV);
    if (!err) err = make_map_3d(&pq.v[kind], v, C, sk, b, w, LQ::BKV);
    if (!err) err = make_map_3d(&pq.qhat[kind], qhat, C, sq, b, w, 64);
    if (!err) err = make_map_3d(&pk.qhat[kind], qhat, C, sq, b, w, LK::BQ);
    if (!err) err = make_map_3d(&pk.dout[kind], dout, C, sq, b, w, LK::BQ);
    if (!err) err = make_map_3d(&pk.k[kind], k, C, sk, b, w, LK::KEYS);
    if (!err) err = make_map_3d(&pk.v[kind], v, C, sk, b, w, LK::KEYS);
    if (err) return static_cast<int>(cudaErrorInvalidValue);
  }
  pq.o = static_cast<const bf16*>(o);
  pq.dout_rows = static_cast<const bf16*>(dout);
  pq.lse = static_cast<const float*>(lse);
  pq.rows = static_cast<float*>(rows);
  pq.dq = static_cast<bf16*>(dq);
  pq.sq = pk.sq = sq;
  pq.sq_pad = pk.sq_pad = (sq + 63) / 64 * 64;
  pq.sk = pk.sk = sk;
  pq.heads = pk.heads = heads;
  pq.scale = scale;
  pk.rows = static_cast<const float*>(rows);
  pk.dk = static_cast<bf16*>(dk);
  pk.dv = static_cast<bf16*>(dv);

  static const cudaError_t dq_set = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::SMEM);
  static const cudaError_t dkv_set = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::SMEM);
  if (dq_set != cudaSuccess) return static_cast<int>(dq_set);
  if (dkv_set != cudaSuccess) return static_cast<int>(dkv_set);
  const dim3 grid_q((sq + LQ::BQ - 1) / LQ::BQ, b * heads);
  flash_bwd_dq_kernel<D><<<grid_q, LQ::THREADS, LQ::SMEM, stream>>>(pq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((sk + LK::KEYS - 1) / LK::KEYS, b * heads);
  flash_bwd_dkv_kernel<D><<<grid_k, LK::THREADS, LK::SMEM, stream>>>(pk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// q, o, dout, dq, qhat: (b, sq, heads·d); k, v, dk, dv: (b, sk, heads·d); all
// contiguous bf16, 16-byte aligned; d % 16 == 0, 16 ≤ d ≤ 256.  lse: the
// forward's fp32 (b, heads, sq) row log-sum-exp (log2 domain); rows: fp32
// (b, heads, 2, sq_pad) scratch, sq_pad = sq rounded up to 64 (lse2 and Δ,
// from the dq kernel to the dk/dv kernel); qhat: scratch for q·scale
// rounded to bf16.
// scale: 1/√d.
AAT_EXPORT int aat_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* rows, void* qhat, void* dq, void* dk, void* dv,
                                       int b, int sq, int sk, int heads, int d, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || sq < 1 || sk < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
#define AAT_FLASH_BWD_CASE(D)                                                                  \
  case D:                                                                                      \
    return aat::launch_bwd<D>(q, k, v, o, dout, lse, rows, qhat, dq, dk, dv, b, sq, sk, heads, \
                              scale, st);
  switch (d) {
    AAT_FLASH_BWD_CASE(16) AAT_FLASH_BWD_CASE(32) AAT_FLASH_BWD_CASE(48) AAT_FLASH_BWD_CASE(64)
    AAT_FLASH_BWD_CASE(80) AAT_FLASH_BWD_CASE(96) AAT_FLASH_BWD_CASE(112) AAT_FLASH_BWD_CASE(128)
    AAT_FLASH_BWD_CASE(144) AAT_FLASH_BWD_CASE(160) AAT_FLASH_BWD_CASE(176)
    AAT_FLASH_BWD_CASE(192) AAT_FLASH_BWD_CASE(208) AAT_FLASH_BWD_CASE(224)
    AAT_FLASH_BWD_CASE(240) AAT_FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AAT_FLASH_BWD_CASE
}
