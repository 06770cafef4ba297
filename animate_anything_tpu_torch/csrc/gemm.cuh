// The row-wise LayerNorm pass and the persistent TMA + wgmma GEMM of kernel
// 2 (csrc/geglu.cu), shared with kernel 5 (csrc/temporal_block.cu), which
// runs the same LayerNorm before its q/k/v products and the same bias +
// residual GEMM as its out-projection, and with kernel 4
// (csrc/proj_residual.cu), which runs that GEMM in its slab form (below).
// Each kernel template takes an Owner tag (ln_geglu_ff, temporal_block,
// proj_residual or ln_qkv) that names the kernel it runs for, so a profile
// attributes the launches to their kernel; kernel 11 (csrc/ln_qkv.cu) takes
// the LN pass's statistics alone.
//
// GEMM design (see geglu.cu's header for the numbers): persistent blocks
// (one a SM, tile after tile with the output-column tile fastest, so the
// blocks in flight share A rows in L2); two consumer warpgroups own 64 rows
// each of a 128-row tile and issue m64nBNk16 wgmma from a ring of 64-column
// K stages (128-byte swizzle, both operands K-major as the torch layouts
// store them), while a producer warp (or, at BN = 256, where the
// accumulator needs more than the 168 registers a thread of a 288-thread
// block, thread 0 between its steps) keeps TMA loads in flight on
// full/empty mbarriers through the tile boundaries.  The epilogue writes
// each warpgroup's 64-row output tile into shared memory in TMA's swizzle
// (the residual form over the residual tile, TMA-loaded there during the
// mainloop) and stores it with one TMA store, so global memory sees whole
// rows, not 4-byte pieces.  Rows past m and columns past n read as zeros
// through the maps and are not stored.
// The slab form (SLABS, the residual GEMM only): the m rows are `slabs`
// slabs of s rows, and every 64-row sub-tile (one warpgroup's) lies within
// one slab, so A, the residual and y are 3-D maps (cols, s, slabs) and
// rows past s read as zeros, never the next slab's.  Two sub-tiles make a
// 128-row tile, so s = 64 fills whole tiles with two slabs.  After its TMA
// store each warpgroup sums its stored bf16 tile's columns over the slab's
// rows and adds Σy, Σy² with one fp32 atomic per column into (slabs, n)
// buffers the caller zeroed (tiles finish in no order).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace aat {

// Owner tags: the kernel a shared template is instantiated for.
struct ln_geglu_ff {};
struct temporal_block {};
struct proj_residual {};
struct ln_qkv {};

namespace gemm {

using namespace hopper;

constexpr int CONSUMERS = 256;  // two warpgroups (and, where the registers allow, a producer warp)
constexpr int BM = 128, BK = 64;         // tile rows; K step (one 128-byte swizzle row)
constexpr int SMEM_LIMIT = 232448;
constexpr int LN_WARPS = 8;   // warps a block of the LN pass
constexpr float kLog2e = 1.4426950408889634f;

// ---- LN ---------------------------------------------------------------------------

// LN(x) of (n, c) rows into ln, bf16, fp32 two-pass statistics over the
// first cs columns (the rest are zero padding, kernel 2 at c % 8 != 0): LPR
// lanes a row (so a warp holds 32 / LPR rows), each lane up to CHUNKS
// 16-byte chunks of it in registers, read once; c <= 8·CHUNKS·LPR.  A row of
// one warp (the first version) left a lane one or two loads in flight at
// c = 320, and the pass ran at a third of HBM's rate.  c % 8 == 0.
// STATS: the statistics alone, each row's (mean, 1/σ) fp32 into `out` (n, 2)
// and no normalised row (kernel 11 normalises its GEMM's A in registers);
// else the normalised rows into `out` (n, c) bf16.
template <int LPR, int CHUNKS, typename Owner, bool STATS>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ b, void* __restrict__ out, int n, int c, int cs,
                  float eps) {
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const int row = (blockIdx.x * LN_WARPS + threadIdx.x / 32) * (32 / LPR) + lane / LPR;
  const bool ok = row < n;  // no early exit: the shuffles take the whole warp
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * c);
  const int chunks = c / 8;
  uint4 v[CHUNKS];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    if (!ok || sub + LPR * k >= chunks) continue;
    v[k] = src[sub + LPR * k];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      sum += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / cs;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    if (!ok || sub + LPR * k >= chunks) continue;
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
    const int col = 8 * (sub + LPR * k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      if (col + 2 * i < cs) sq += (f.x - mu) * (f.x - mu);
      if (col + 2 * i + 1 < cs) sq += (f.y - mu) * (f.y - mu);
    }
  }
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / cs + eps);
  if (STATS) {
    if (ok && sub == 0) static_cast<float2*>(out)[row] = make_float2(mu, rstd);
    return;
  }
  uint4* dst = static_cast<uint4*>(out) + (size_t)row * chunks;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int u = sub + LPR * k;
    if (!ok || u >= chunks) continue;
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      const int col = 8 * u + 2 * i;
      o[i] = pack_bf16((f.x - mu) * rstd * s[col] + b[col],
                       (f.y - mu) * rstd * s[col + 1] + b[col + 1]);
    }
    dst[u] = out;
  }
}

template <int LPR, int CHUNKS, typename Owner, bool STATS>
int launch_layer_norm_lpr(const void* x, const void* s, const void* b, void* out, int n, int c,
                          int cs, float eps, cudaStream_t stream) {
  constexpr int rows = LN_WARPS * (32 / LPR);  // a block's
  layer_norm_kernel<LPR, CHUNKS, Owner, STATS>
      <<<(n + rows - 1) / rows, LN_WARPS * 32, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const float*>(s),
          static_cast<const float*>(b), out, n, c, cs, eps);
  return static_cast<int>(cudaGetLastError());
}

// The LN pass for c <= 4096, statistics over the first cs columns: 8 lanes
// a row up to c = 512, 16 up to 1024, else 32 (at most 8 chunks a lane, 16
// past c = 2048).  `out` as layer_norm_kernel's.
template <typename Owner, bool STATS = false>
int launch_layer_norm(const void* x, const void* s, const void* b, void* out, int n, int c,
                      int cs, float eps, cudaStream_t stream) {
  if (n < 1 || c < 8 || c % 8 != 0 || c > 4096 || cs < 1 || cs > c)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c <= 512)
    return launch_layer_norm_lpr<8, 8, Owner, STATS>(x, s, b, out, n, c, cs, eps, stream);
  if (c <= 1024)
    return launch_layer_norm_lpr<16, 8, Owner, STATS>(x, s, b, out, n, c, cs, eps, stream);
  if (c <= 2048)
    return launch_layer_norm_lpr<32, 8, Owner, STATS>(x, s, b, out, n, c, cs, eps, stream);
  return launch_layer_norm_lpr<32, 16, Owner, STATS>(x, s, b, out, n, c, cs, eps, stream);
}

// ---- the GEMMs ------------------------------------------------------------------

struct GemmParams {
  CUtensorMap a;       // (k cols, m rows) bf16, box 64 x BM
  CUtensorMap b;       // (k cols, weight rows) bf16, box 64 x (GEGLU ? BN/2 : BN)
  CUtensorMap out[2];  // (n cols, m rows) bf16, boxes 64 and 32 columns x 64 rows
  CUtensorMap res[2];  // the residual, as `out` (the residual form only)
  const float* bias;   // GEGLU: b1 (8c, val then gate); else the output bias (n)
  int m, n, k;         // rows, output columns (GEGLU: act's 4c), reduction
  int gate_row0;       // GEGLU: the W1 row (and b1 entry) of gate column 0, 4c
  int col_tiles, tiles, stages;
  int s, subs_per_slab, subs;  // the slab form: rows a slab, 64-row sub-tiles a slab, in all
  float* s1;                   // the slab form: (slabs, n) fp32 Σy, Σy², zeroed
  float* s2;
};

// The slab form's sub-tile h (0, 1) of 128-row tile `pair`: whether it
// exists (the last tile of an odd count has one), its slab and first row.
struct SlabRows {
  bool on;
  int slab, s0;
};
__device__ __forceinline__ SlabRows slab_rows(const GemmParams& p, int pair, int h) {
  const int sub = 2 * pair + h;
  SlabRows r;
  r.on = sub < p.subs;
  r.slab = r.on ? sub / p.subs_per_slab : 0;
  r.s0 = r.on ? (sub % p.subs_per_slab) * 64 : 0;
  return r;
}

// Shared memory of a GEMM block: the ring of K stages (A then B tile), then
// each consumer warpgroup's 64-row output tile (OUT columns, as 64- and
// 32-column chunks in the TMA swizzle), then the barriers: per stage full
// and empty, per warpgroup one for its residual tile.
template <int BN, bool GEGLU>
struct GemmLayout {
  static constexpr int OUT = GEGLU ? BN / 2 : BN;  // output columns a tile
  using Chunks = HeadChunks<OUT>;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = 64 * OUT * 2;  // one warpgroup's output tile
  static constexpr int smem(int stages) {
    return 1024 + stages * (STAGE_BYTES + 16) + 2 * OUT_BYTES + 16;
  }
  // A producer warp where the 64 x BN accumulator fits the 168 registers a
  // thread of a 288-thread block (three warps share a sub-partition's
  // register file); at BN = 256 the two warpgroups alone (255), thread 0
  // issuing the loads.
  static constexpr bool PRODUCER = BN < 256;
  static constexpr int THREADS = CONSUMERS + (PRODUCER ? 32 : 0);
  static_assert(OUT % 32 == 0, "output chunks of 64 and 32 columns");
};

// K step g of this block's tiles (tile blockIdx.x + (g / nk)·gridDim.x,
// step g % nk) into its stage, once the consumers have released the
// stage's previous step (one thread).
template <int BN, bool GEGLU, bool SLABS>
__device__ __forceinline__ void gemm_load_step(const GemmParams& p, const Ring& ring, int nk,
                                               int g) {
  using L = GemmLayout<BN, GEGLU>;
  const int tile = blockIdx.x + (g / nk) * gridDim.x, kb = g % nk;
  const int row_tile = tile / p.col_tiles, ct = tile % p.col_tiles;
  const uint32_t st = ring.stage(g);
  uint32_t bar;
  if constexpr (SLABS) {  // one box a sub-tile, none for a missing one
    const SlabRows r0 = slab_rows(p, row_tile, 0), r1 = slab_rows(p, row_tile, 1);
    bar = ring.acquire(g, (r0.on + r1.on) * (L::A_BYTES / 2) + L::B_BYTES);
    if (r0.on) tma_load_3d(st, &p.a, bar, kb * BK, r0.s0, r0.slab);
    if (r1.on) tma_load_3d(st + L::A_BYTES / 2, &p.a, bar, kb * BK, r1.s0, r1.slab);
  } else {
    bar = ring.acquire(g, L::STAGE_BYTES);
    tma_load_3d(st, &p.a, bar, kb * BK, row_tile * BM, 0);
  }
  if constexpr (GEGLU) {
    tma_load_3d(st + L::A_BYTES, &p.b, bar, kb * BK, ct * (BN / 2), 0);
    tma_load_3d(st + L::A_BYTES + (BN / 2) * BK * 2, &p.b, bar, kb * BK,
                p.gate_row0 + ct * (BN / 2), 0);
  } else {
    tma_load_3d(st + L::A_BYTES, &p.b, bar, kb * BK, ct * BN, 0);
  }
}

// gelu_tanh(g) = 0.5·g·(1 + tanh(z)) = g·sigmoid(2z), z = √(2/π)·(g + 0.044715·g³):
// one ex2 and one divide (the exponent is clamped so 1 + e stays finite).
__device__ __forceinline__ float gelu_tanh(float g) {
  const float z = 0.7978845608028654f * fmaf(0.044715f * g, g * g, g);
  const float e = exp2_ftz(fminf(-2.f * kLog2e * z, 126.f));
  return __fdividef(g, 1.f + e);
}

// The tile's epilogue into the warpgroup's output tile `out` (shared):
// GEGLU, act columns [j0, j0 + BN/2) from the val half and the gate half of
// the accumulator (gate column x sits BN/2 after val column x: n8 block
// jj + BN/16), + b1, val·gelu_tanh(gate); else y = acc + bias + residual
// over the residual tile already in `out`, in place.  Rows are the thread's
// two of the warpgroup's 64.
template <int BN, bool GEGLU>
__device__ __forceinline__ void epilogue(const GemmParams& p, const float* acc, uint8_t* out,
                                         int r0, int j0, int t) {
  using L = GemmLayout<BN, GEGLU>;
#pragma unroll
  for (int jj = 0; jj < L::OUT / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (!GEGLU && j0 + col >= p.n) continue;  // past n: not stored
    // GEGLU: a last tile past 4c takes the last column's biases for the act
    // columns it does not store (no branch, no read past b1)
    const int bc = GEGLU ? min(j0 + col, p.n - 2) : j0 + col;
    const float2 bv = *reinterpret_cast<const float2*>(p.bias + bc);
    float2 bg;
    if constexpr (GEGLU) bg = *reinterpret_cast<const float2*>(p.bias + p.gate_row0 + bc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(out + out_offset<typename L::Chunks>(r0 + 8 * h, col));
      const float* v = acc + 4 * jj + 2 * h;
      if constexpr (GEGLU) {
        const float* g = acc + 4 * (jj + BN / 16) + 2 * h;
        *dst = pack_bf16((v[0] + bv.x) * gelu_tanh(g[0] + bg.x),
                         (v[1] + bv.y) * gelu_tanh(g[1] + bg.y));
      } else {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
        *dst = pack_bf16(v[0] + bv.x + x.x, v[1] + bv.y + x.y);
      }
    }
  }
}

// The slab form's Σy, Σy² of the warpgroup's stored output tile `out`
// (OUT columns from j0, `rows` rows of slab `slab`): two columns a thread,
// one fp32 atomic each.
template <typename Chunks, int OUT>
__device__ __forceinline__ void column_sums(const GemmParams& p, const uint8_t* out, int j0,
                                            int slab, int rows, int lt) {
  const int col = 2 * lt;
  if (col >= OUT || j0 + col >= p.n) return;
  float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f;
  for (int r = 0; r < rows; ++r) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(out + out_offset<Chunks>(r, col)));
    a0 += v.x;
    a1 += v.y;
    q0 = fmaf(v.x, v.x, q0);
    q1 = fmaf(v.y, v.y, q1);
  }
  const size_t o = (size_t)slab * p.n + j0 + col;
  atomicAdd(p.s1 + o, a0);
  atomicAdd(p.s1 + o + 1, a1);
  atomicAdd(p.s2 + o, q0);
  atomicAdd(p.s2 + o + 1, q1);
}

template <int BN, bool GEGLU, typename Owner, bool SLABS = false>
__global__ void __launch_bounds__(GemmLayout<BN, GEGLU>::THREADS, 1)
tma_gemm_kernel(const __grid_constant__ GemmParams p) {
  using L = GemmLayout<BN, GEGLU>;
  using Chunks = typename L::Chunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages;
  const uint32_t outs = base + stages * L::STAGE_BYTES;  // two output tiles
  const uint32_t full = outs + 2 * L::OUT_BYTES, empty = full + 8 * stages,
                 res_full = empty + 8 * stages;
  const Ring ring{base, full, empty, static_cast<uint32_t>(L::STAGE_BYTES), stages};
  const int tid = threadIdx.x;
  const int nk = (p.k + BK - 1) / BK;

  if (tid == 0) {
    ring.init(CONSUMERS);
    mbar_init(res_full, 1);
    mbar_init(res_full + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // this block's K steps over all its tiles
  const int steps = (blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * nk;
  if constexpr (L::PRODUCER) {
    if (tid >= CONSUMERS) {
      // ---- producer warp: one thread streams every K step of every tile --
      if (tid == CONSUMERS)
        for (int g = 0; g < steps; ++g) gemm_load_step<BN, GEGLU, SLABS>(p, ring, nk, g);
      return;
    }
  } else {
    if (tid == 0)
      for (int g = 0; g < steps && g < stages; ++g)
        gemm_load_step<BN, GEGLU, SLABS>(p, ring, nk, g);
    __syncwarp();
  }
  // Release step g's stage; without a producer warp, thread 0 refills it.
  auto release = [&](int g) {
    ring.release(g);
    if constexpr (!L::PRODUCER) {
      if (tid == 0 && g + stages < steps)
        gemm_load_step<BN, GEGLU, SLABS>(p, ring, nk, g + stages);
      __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
    }
  };

  // ---- consumers: warpgroup wg owns rows [64·wg, 64·wg + 64) of each tile ---
  const int wg = tid / 128, lt = tid % 128, t = lt & 3;
  const int r0 = (lt / 32) * 16 + (lt & 31) / 4;  // the thread's first row of the 64
  const uint32_t out = outs + wg * L::OUT_BYTES, res_bar = res_full + 8 * wg;
  uint8_t* out_ptr = smem_raw + (out - raw);
  float acc[BN / 2];
  int it = 0, local = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++local) {
    const int row_tile = tile / p.col_tiles, ct = tile % p.col_tiles;
    const int j0 = ct * L::OUT;
    // the warpgroup's 64 rows: row0.. of slab `slab` (the slab form), else of the m rows
    SlabRows me{true, 0, row_tile * BM + 64 * wg};
    if constexpr (SLABS) me = slab_rows(p, row_tile, wg);
    const int row0 = me.s0;
    if (lt == 0) {
      bulk_wait_read();  // the last tile's store has read the output tile
      if constexpr (!GEGLU) {  // the residual tile, in place of the output
        if (me.on) {
          mbar_expect_tx(res_bar, L::OUT_BYTES);
#pragma unroll
          for (int i = 0; i < Chunks::COUNT; ++i)
            tma_load_3d(out + Chunks::offset(i, 64), &p.res[Chunks::kind(i)], res_bar,
                        j0 + Chunks::col(i), row0, me.slab);
        } else {
          mbar_arrive(res_bar);  // no sub-tile: complete the phase without bytes
        }
      }
    }
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const uint32_t st = ring.stage(it);
      ring.wait_full(it);
      fence_all<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<BN>(acc, desc_k_major(st + wg * 64 * 128 + 32 * kk, 128),
                     desc_k_major(st + L::A_BYTES + 32 * kk, 128), kb + kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // step kb − 1 is done: release its stage
      fence_all<BN / 2>(acc);
      if (kb > 0) release(it - 1);
    }
    wgmma_wait<0>();
    fence_all<BN / 2>(acc);
    release(it - 1);

    named_bar_sync(1 + wg, 128);  // thread 0's wait for the last store is behind everyone
    if constexpr (!GEGLU) mbar_wait(res_bar, local & 1);
    epilogue<BN, GEGLU>(p, acc, out_ptr, r0, j0, t);
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (lt == 0 && me.on) {  // rows past m (s) and columns past n are not written
#pragma unroll
      for (int i = 0; i < Chunks::COUNT; ++i)
        tma_store_3d(&p.out[Chunks::kind(i)], out + Chunks::offset(i, 64), j0 + Chunks::col(i),
                     row0, me.slab);
      bulk_commit();
    }
    if constexpr (SLABS) {
      if (me.on) column_sums<Chunks, L::OUT>(p, out_ptr, j0, me.slab, min(64, p.s - row0), lt);
      named_bar_sync(1 + wg, 128);  // the sums have read the tile before the next residual load
    }
  }
  if (lt == 0) bulk_wait();
}

template <int BN, bool GEGLU, typename Owner, bool SLABS = false>
int launch_gemm(GemmParams& p, const void* a, const void* w, int w_rows, void* out,
                const void* res, int grid, int smem, cudaStream_t stream) {
  using L = GemmLayout<BN, GEGLU>;
  if (p.stages < 2 || smem < L::smem(p.stages) || smem > SMEM_LIMIT || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows as (s, slabs) in the slab form, else (m, 1); A boxes of 64 or BM rows
  const uint64_t rows = SLABS ? p.s : p.m, slabs = SLABS ? p.m / p.s : 1;
  int err = make_map_3d(&p.a, a, p.k, rows, slabs, BK, SLABS ? 64 : BM);
  if (!err) err = make_map_3d(&p.b, w, p.k, w_rows, 1, BK, GEGLU ? BN / 2 : BN);
  for (int kind = 0; kind < 2 && !err; ++kind) {
    err = make_map_3d(&p.out[kind], out, p.n, rows, slabs, 64 >> kind, 64);
    if (!err && res != nullptr)
      err = make_map_3d(&p.res[kind], res, p.n, rows, slabs, 64 >> kind, 64);
  }
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(tma_gemm_kernel<BN, GEGLU, Owner, SLABS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tma_gemm_kernel<BN, GEGLU, Owner, SLABS><<<grid, L::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// y (m, n) = a (m, k)·wᵀ + bias + res, w (n, k): the residual form, tile
// width bn in 256, 160, 128, 64 (the launch plan's, ops/geglu.py::gemm_plan).
template <typename Owner>
int gemm_bias_residual(const void* a, const void* w, const void* bias, const void* res, void* y,
                       int m, int n, int k, int bn, int stages, int grid, int smem,
                       cudaStream_t stream) {
  GemmParams p = {};
  p.bias = static_cast<const float*>(bias);
  p.m = m;
  p.n = n;
  p.k = k;
  p.col_tiles = (n + bn - 1) / bn;
  p.tiles = (m + BM - 1) / BM * p.col_tiles;
  p.stages = stages;
  switch (bn) {
    case 256: return launch_gemm<256, false, Owner>(p, a, w, n, y, res, grid, smem, stream);
    case 160: return launch_gemm<160, false, Owner>(p, a, w, n, y, res, grid, smem, stream);
    case 128: return launch_gemm<128, false, Owner>(p, a, w, n, y, res, grid, smem, stream);
    case 64: return launch_gemm<64, false, Owner>(p, a, w, n, y, res, grid, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The slab form: h (slabs, s, k), y and res (slabs, s, n); y = h·wᵀ + bias +
// res with Σy, Σy² of the stored y per (slab, column) added into s1, s2
// (slabs, n), zeroed by the caller.  Tile width bn in 256, 160, 128, 64
// (the launch plan's, ops/proj_residual.py::launch_plan).
template <typename Owner>
int gemm_bias_residual_stats(const void* a, const void* w, const void* bias, const void* res,
                             void* y, float* s1, float* s2, int slabs, int s, int n, int k,
                             int bn, int stages, int grid, int smem, cudaStream_t stream) {
  if (slabs < 1 || s < 1 || res == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p = {};
  p.bias = static_cast<const float*>(bias);
  p.m = slabs * s;
  p.n = n;
  p.k = k;
  p.s = s;
  p.subs_per_slab = (s + 63) / 64;
  p.subs = slabs * p.subs_per_slab;
  p.s1 = s1;
  p.s2 = s2;
  p.col_tiles = (n + bn - 1) / bn;
  p.tiles = (p.subs + 1) / 2 * p.col_tiles;
  p.stages = stages;
  switch (bn) {
    case 256: return launch_gemm<256, false, Owner, true>(p, a, w, n, y, res, grid, smem, stream);
    case 160: return launch_gemm<160, false, Owner, true>(p, a, w, n, y, res, grid, smem, stream);
    case 128: return launch_gemm<128, false, Owner, true>(p, a, w, n, y, res, grid, smem, stream);
    case 64: return launch_gemm<64, false, Owner, true>(p, a, w, n, y, res, grid, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gemm
}  // namespace aat
