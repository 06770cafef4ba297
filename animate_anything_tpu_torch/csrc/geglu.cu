// Kernel 2: LayerNorm -> GEGLU feed-forward -> + residual, on TMA and wgmma.
//
// Replaces animate_anything_tpu/ops/geglu.py::_pallas_ln_geglu (_kernel,
// c <= 640) and ::_pallas_ln_geglu_wide (_wide_kernel, c = 1280) with one
// code path for every c % 16 == 0 up to 1280:
//     y = x + W2·(val ⊙ gelu_tanh(gate)) + b2,   [val ‖ gate] = LN(x)·W1 + b1
// with LN statistics in fp32, LN(x) rounded to bf16 before W1, the GEGLU
// product rounded to bf16 before W2 and the residual added in fp32.
//
// Bound on the H100: tensor-core math, 24·c² flops a row against 4·c bytes
// of x and y (the weights, 24·c² bytes, stay in L2).  The TPU kernels keep
// the (rows, c) fp32 output accumulator in VMEM while the 4c hidden streams
// past; on Hopper one wgmma warpgroup owns 64 rows, and a 64 x c fp32
// accumulator is c/2 registers a thread (640 at c = 1280, past the 255 a
// thread may have), so the whole hidden cannot stay on chip for every c.
// Design: three launches, the two products as TMA + wgmma GEMMs with fused
// prologue and epilogue:
// - LN: one warp a row, read once into registers, fp32 two-pass
//   statistics, LN(x) stored as bf16 (4·n·c bytes);
// - GEMM 1, act = GEGLU(LN(x)·W1ᵀ + b1): each tile pairs val columns
//   [j, j + BN/2) with gate columns [4c + j, 4c + j + BN/2) as two TMA
//   boxes of one W1 map stacked in one B tile, so a thread holds each
//   val/gate pair in one accumulator; the epilogue adds b1, takes
//   val·gelu_tanh(gate) in fp32 and stores act (n x 4c) as bf16;
// - GEMM 2, y = act·W2ᵀ + b2 + x: the epilogue adds b2 and the residual in
//   fp32 and stores y as bf16.
// The fusion boundary differs from the TPU kernels' in one place: act, 4c
// wide in bf16, goes through device memory (16·n·c bytes written and read
// back: at the H100's 3.35 TB/s at most 0.34 ms on the main path, beside
// its 0.35-0.89 ms FLOP bound at 989 TFLOP/s); no fp32 or 8c-wide hidden
// ever does, and both biases and the residual stay fused.
// Both GEMMs: persistent blocks (one a SM, tile after tile with the
// output-column tile fastest, so the blocks in flight share A rows in L2);
// two consumer warpgroups own 64 rows each of a 128-row tile and issue
// m64nBNk16 wgmma from a ring of 64-column K stages (128-byte swizzle, both
// operands K-major as the torch layouts store them), while a producer warp
// (or, at BN = 256, where the accumulator needs more than the 168
// registers a thread of a 288-thread block, thread 0 between its steps)
// keeps TMA loads in flight on full/empty mbarriers through the tile
// boundaries.  The epilogue writes each warpgroup's 64-row output tile into
// shared memory in TMA's swizzle (GEMM 2 over the residual tile, TMA-loaded
// there during the mainloop) and stores it with one TMA store, so global
// memory sees whole rows, not 4-byte pieces.  Rows past n and columns past
// c read as zeros through the maps and are not stored.
// Tiles, ring depth, grid and shared-memory bytes come from the wrapper's
// launch plan (ops/geglu.py::launch_plan), checked here.
#include "common.cuh"
#include "hopper.cuh"

namespace aat {
namespace {

using namespace hopper;

constexpr int CONSUMERS = 256;  // two warpgroups (and, where the registers allow, a producer warp)
constexpr int BM = 128, BK = 64;         // tile rows; K step (one 128-byte swizzle row)
constexpr int SMEM_LIMIT = 232448;
constexpr int LN_ROWS = 8;  // rows (warps) a block of the LN pass
constexpr int LN_CHUNKS = 5;  // 16-byte chunks a lane holds: c <= 32 * 5 * 8 = 1280
constexpr float kLog2e = 1.4426950408889634f;

// ---- LN ---------------------------------------------------------------------------

__global__ void __launch_bounds__(LN_ROWS * 32)
ln_geglu_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ b, bf16* __restrict__ ln, int n, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= n) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * c);
  uint4* dst = reinterpret_cast<uint4*>(ln + (size_t)row * c);
  const int chunks = c / 8;
  // The row in registers, read once: 16-byte chunks lane, lane + 32, ...
  uint4 v[LN_CHUNKS];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < LN_CHUNKS; ++k) {
    if (lane + 32 * k >= chunks) continue;
    v[k] = src[lane + 32 * k];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      sum += f.x + f.y;
    }
  }
  const float mu = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < LN_CHUNKS; ++k) {
    if (lane + 32 * k >= chunks) continue;
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      sq += (f.x - mu) * (f.x - mu) + (f.y - mu) * (f.y - mu);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / c + eps);
#pragma unroll
  for (int k = 0; k < LN_CHUNKS; ++k) {
    const int u = lane + 32 * k;
    if (u >= chunks) continue;
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

// ---- the GEMMs ------------------------------------------------------------------

struct GemmParams {
  CUtensorMap a;       // (k cols, m rows) bf16, box 64 x BM
  CUtensorMap b;       // (k cols, weight rows) bf16, box 64 x (GEGLU ? BN/2 : BN)
  CUtensorMap out[2];  // (n cols, m rows) bf16, boxes 64 and 32 columns x 64 rows
  CUtensorMap res[2];  // the residual x, as `out` (GEMM 2 only)
  const float* bias;   // GEGLU: b1 (8c, val then gate); else b2 (c)
  int m, n, k;         // rows, output columns (GEGLU: act's 4c), reduction
  int gate_row0;       // GEGLU: the W1 row (and b1 entry) of gate column 0, 4c
  int col_tiles, tiles, stages;
};

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
template <int BN, bool GEGLU>
__device__ __forceinline__ void gemm_load_step(const GemmParams& p, uint32_t base, uint32_t full,
                                               uint32_t empty, int nk, int g) {
  using L = GemmLayout<BN, GEGLU>;
  const int tile = blockIdx.x + (g / nk) * gridDim.x, kb = g % nk, s = g % p.stages;
  const int m0 = (tile / p.col_tiles) * BM, ct = tile % p.col_tiles;
  const uint32_t st = base + s * L::STAGE_BYTES, bar = full + 8 * s;
  mbar_wait(empty + 8 * s, ((g / p.stages) & 1) ^ 1);
  mbar_expect_tx(bar, L::STAGE_BYTES);
  tma_load_3d(st, &p.a, bar, kb * BK, m0, 0);
  if constexpr (GEGLU) {
    tma_load_3d(st + L::A_BYTES, &p.b, bar, kb * BK, ct * (BN / 2), 0);
    tma_load_3d(st + L::A_BYTES + (BN / 2) * BK * 2, &p.b, bar, kb * BK,
                p.gate_row0 + ct * (BN / 2), 0);
  } else {
    tma_load_3d(st + L::A_BYTES, &p.b, bar, kb * BK, ct * BN, 0);
  }
}

// Byte offset of (row, col) in a warpgroup's output tile: the chunk holding
// col, then TMA's swizzle of its rows (16-byte units XORed with the row's
// position in the swizzle atom).
template <typename Chunks>
__device__ __forceinline__ uint32_t out_offset(int row, int col) {
  const int i = col < 64 * Chunks::N64 ? col / 64 : Chunks::N64;
  const int rb = 2 * Chunks::width(i);
  const uint32_t o = row * rb + (col - Chunks::col(i)) * 2;
  const uint32_t atom_rows = rb == 128 ? 7 : 3;  // 128- or 64-byte swizzle
  return Chunks::offset(i, 64) + (o ^ (((o >> 7) & atom_rows) << 4));
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
// jj + BN/16), + b1, val·gelu_tanh(gate); else y = acc + b2 + x over the
// residual tile already in `out`, in place.  Rows are the thread's two of
// the warpgroup's 64.
template <int BN, bool GEGLU>
__device__ __forceinline__ void epilogue(const GemmParams& p, const float* acc, uint8_t* out,
                                         int r0, int j0, int t) {
  using L = GemmLayout<BN, GEGLU>;
#pragma unroll
  for (int jj = 0; jj < L::OUT / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (!GEGLU && j0 + col >= p.n) continue;  // past c: not stored
    const float2 bv = *reinterpret_cast<const float2*>(p.bias + j0 + col);
    float2 bg;
    if constexpr (GEGLU) bg = *reinterpret_cast<const float2*>(p.bias + p.gate_row0 + j0 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + out_offset<typename L::Chunks>(r0 + 8 * h, col));
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

template <int BN, bool GEGLU>
__global__ void __launch_bounds__(GemmLayout<BN, GEGLU>::THREADS, 1)
ln_geglu_gemm_kernel(const __grid_constant__ GemmParams p) {
  using L = GemmLayout<BN, GEGLU>;
  using Chunks = typename L::Chunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages;
  const uint32_t outs = base + stages * L::STAGE_BYTES;  // two output tiles
  const uint32_t full = outs + 2 * L::OUT_BYTES, empty = full + 8 * stages,
                 res_full = empty + 8 * stages;
  const int tid = threadIdx.x;
  const int nk = (p.k + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
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
        for (int g = 0; g < steps; ++g) gemm_load_step<BN, GEGLU>(p, base, full, empty, nk, g);
      return;
    }
  } else {
    if (tid == 0)
      for (int g = 0; g < steps && g < stages; ++g)
        gemm_load_step<BN, GEGLU>(p, base, full, empty, nk, g);
    __syncwarp();
  }
  // Release step g's stage; without a producer warp, thread 0 refills it.
  auto release = [&](int g) {
    mbar_arrive(empty + 8 * (g % stages));
    if constexpr (!L::PRODUCER) {
      if (tid == 0 && g + stages < steps)
        gemm_load_step<BN, GEGLU>(p, base, full, empty, nk, g + stages);
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
    const int m0 = (tile / p.col_tiles) * BM, ct = tile % p.col_tiles;
    const int j0 = ct * L::OUT, row0 = m0 + 64 * wg;
    if (lt == 0) {
      bulk_wait_read();  // the last tile's store has read the output tile
      if constexpr (!GEGLU) {  // the residual tile, in place of the output
        mbar_expect_tx(res_bar, L::OUT_BYTES);
#pragma unroll
        for (int i = 0; i < Chunks::COUNT; ++i)
          tma_load_3d(out + Chunks::offset(i, 64), &p.res[Chunks::kind(i)], res_bar,
                      j0 + Chunks::col(i), row0, 0);
      }
    }
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % stages;
      const uint32_t st = base + s * L::STAGE_BYTES;
      mbar_wait(full + 8 * s, (it / stages) & 1);
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
    if (lt == 0) {  // rows past m and columns past n are not written
#pragma unroll
      for (int i = 0; i < Chunks::COUNT; ++i)
        tma_store_3d(&p.out[Chunks::kind(i)], out + Chunks::offset(i, 64), j0 + Chunks::col(i),
                     row0, 0);
      bulk_commit();
    }
  }
  if (lt == 0) bulk_wait();
}

template <int BN, bool GEGLU>
int launch_gemm(GemmParams& p, const void* a, const void* w, int w_rows, void* out,
                const void* res, int grid, int smem, cudaStream_t stream) {
  using L = GemmLayout<BN, GEGLU>;
  if (p.stages < 2 || smem < L::smem(p.stages) || smem > SMEM_LIMIT || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = make_map_3d(&p.a, a, p.k, p.m, 1, BK, BM);
  if (!err) err = make_map_3d(&p.b, w, p.k, w_rows, 1, BK, GEGLU ? BN / 2 : BN);
  for (int kind = 0; kind < 2 && !err; ++kind) {
    err = make_map_3d(&p.out[kind], out, p.n, p.m, 1, 64 >> kind, 64);
    if (!err && res != nullptr) err = make_map_3d(&p.res[kind], res, p.n, p.m, 1, 64 >> kind, 64);
  }
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ln_geglu_gemm_kernel<BN, GEGLU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_geglu_gemm_kernel<BN, GEGLU><<<grid, L::THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// x, y: (n, c) bf16; w1: (8c, c) bf16 [val rows, then gate rows]; w2: (c, 4c)
// bf16; ln_s, ln_b, b2: (c,) fp32; b1: (8c,) fp32; ln: (n, c) and act: (n, 4c)
// bf16 scratch.  c % 16 == 0, c <= 1280; all 16-byte aligned.  The launch
// plan (ops/geglu.py::launch_plan): GEMM 1's tile width bn1 (128 or 256:
// bn1/2 val and bn1/2 gate columns), ring stages, grid and dynamic shared
// bytes; GEMM 2's likewise (bn2 in 64, 128, 160, 256); gate_row0 = 4c.
AAT_EXPORT int aat_ln_geglu(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y, void* ln,
                            void* act, int n, int c, float eps, int bn1, int stages1, int grid1,
                            int smem1, int bn2, int stages2, int grid2, int smem2, int gate_row0,
                            void* stream) {
  using namespace aat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int inner = 4 * c;
  if (n < 1 || c % 16 != 0 || c > 1280 || gate_row0 != inner || inner % (bn1 / 2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ln_geglu_ln_kernel<<<(n + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(ln), n, c, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int row_tiles = (n + BM - 1) / BM;
  GemmParams p1 = {};
  p1.bias = static_cast<const float*>(b1);
  p1.m = n;
  p1.n = inner;
  p1.k = c;
  p1.gate_row0 = gate_row0;
  p1.col_tiles = inner / (bn1 / 2);
  p1.tiles = row_tiles * p1.col_tiles;
  p1.stages = stages1;
  if (bn1 == 256)
    err = launch_gemm<256, true>(p1, ln, w1, 8 * c, act, nullptr, grid1, smem1, st);
  else if (bn1 == 128)
    err = launch_gemm<128, true>(p1, ln, w1, 8 * c, act, nullptr, grid1, smem1, st);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;

  GemmParams p2 = {};
  p2.bias = static_cast<const float*>(b2);
  p2.m = n;
  p2.n = c;
  p2.k = inner;
  p2.col_tiles = (c + bn2 - 1) / bn2;
  p2.tiles = row_tiles * p2.col_tiles;
  p2.stages = stages2;
  switch (bn2) {
    case 256: return launch_gemm<256, false>(p2, act, w2, c, y, x, grid2, smem2, st);
    case 160: return launch_gemm<160, false>(p2, act, w2, c, y, x, grid2, smem2, st);
    case 128: return launch_gemm<128, false>(p2, act, w2, c, y, x, grid2, smem2, st);
    case 64: return launch_gemm<64, false>(p2, act, w2, c, y, x, grid2, smem2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
