// Kernel 5: the fused temporal-attention block on TMA and wgmma.
//
// Replaces animate_anything_tpu/ops/temporal_block.py::_build_bfsc
// (_kernel_bfsc) and ::_build (_kernel, with the head-group split of
// _build_vjp) with one code path on the natural (b, f, s, c) layout:
//     y = x + bo + Wo·attn(LN(x)),   q|k|v = LN(x)·Wq|k|vᵀ,
// attention over the f frames of each (batch, location, head).  LN
// statistics, scores and softmax are fp32; LN(x), q, k, v, the probabilities
// and the attention output are rounded to bf16 before their next product,
// as in the JAX reference (_reference_bfsc).
//
// Bound on the H100: tensor-core math in the four c x c projections (8·c²
// flops a row); the frame attention adds 4·f·c flops a row.  Design, three
// launches:
// 1. LN(x) into a bf16 scratch (n, c): kernel 2's LayerNorm pass
//    (gemm.cuh), c <= 2048;
// 2. q/k/v and the frame attention, one persistent kernel over work items
//    (row tile, head), head fastest, so the blocks in flight share the
//    row tile in L2:
//    - a row tile is L = ⌊128/f⌋ locations x f frames of one batch in
//      frame-major order, row = frame·L + loc (the TPU kernel's packing,
//      _kernel_bfsc): one TMA box (64 columns, L locations, f frames) of a
//      3-D map over LN(x) as (c, s, b·f).  Rows past s read as zeros and the
//      tile's rows past L·f are zeroed once, so every row stays finite
//      (the TPU kernel's edge block reads garbage past s; its P·V leaks the
//      NaN of 0·garbage into real rows, ROADMAP queue 3);
//    - the head's d columns go in chunks of 64: per chunk one m64n192k16
//      wgmma stream over K = c computes q‖k‖v = LN·[Wq; Wk; Wv]ᵀ from a TMA
//      ring (A the LN tile's 64-column step, B three 64-row weight boxes),
//      two consumer warpgroups of 64 rows, the first thread refilling each
//      stage as it is released.  No producer warp: the 96 accumulator
//      registers of a chunk beside the 64 of the scores need the 255 a
//      thread of a 256-thread block has (a producer warp at d <= 64, whose
//      accumulators and scores are never live together, fit 168 registers
//      only with spills, and was slower by a quarter).  Columns past d, and
//      so any d % 16 == 8 padded to 64, are written as zeros;
//    - q, k and v of the chunk go to shared memory in bf16 (128-byte
//      swizzle), and S += q·kᵀ runs over the whole tile (m64n128k16, fp32
//      in registers), masked to keys of the same location (col ≡ row mod L,
//      col < L·f) with a select, as the TPU kernel's dense masked tile;
//    - the fp32 softmax (exp2 of scores·log2 e/√d) on the S registers, P
//      rounded to bf16 as the register A operand of o = P·v (v MN-major
//      from shared memory, m64n64k16 a chunk); o in bf16 to device memory
//      through the freed q or k tile and one TMA store of the tile's box (a
//      last chunk narrower than 64 columns from registers, as the box would
//      cover the next head's columns);
//    the products do not bound it (a run without them was 7 % faster at
//    s = 4096, c = 320): the loads (the first thread's refill waits for the
//    other warpgroup's release, a third of a step) and the attention phase
//    of each item, in which the tensor cores idle, do;
// 3. y = o·Woᵀ + bo + x: kernel 2's residual GEMM (gemm.cuh) with K = c.
// LN(x) and o go through device memory (4·n·c bytes each way; at s = 4096,
// c = 320, 2 x 89 MB, 0.053 ms at 3.35 TB/s): the ground rules' second
// fusion-boundary exception.  L2 bytes per call of launch 2: per item a
// chunk reads its 128 x c A rows and 192 x c weight rows, 640·c bytes for
// 2·128·192·c flops (77 flops a byte); items x chunks x 640·c in all (at
// s = 4096, c = 320, 5 heads: 2·586·5 x 204,800 ≈ 1.2 GB from L2).
// Tiles, ring depth, grid and shared memory come from the wrapper's launch
// plan (ops/temporal_block.py::launch_plan), checked here.
#include "gemm.cuh"

namespace aat {
namespace {

using namespace hopper;

constexpr int ROWS = 128;                  // rows of a row tile (two warpgroups)
constexpr int A_BYTES = ROWS * 128;        // the LN tile's 64-column step
constexpr int W_BYTES = 64 * 128;          // one weight box: 64 rows x 64 columns
constexpr int STAGE_BYTES = A_BYTES + 3 * W_BYTES;
constexpr int TILE_BYTES = ROWS * 128;     // q, k or a v chunk: 128 rows x 64 columns
constexpr int MAX_CHUNKS = 4;              // d <= 256
constexpr int THREADS = 256;

__host__ __device__ constexpr int attention_smem(int stages, int chunks) {
  return 1024 + stages * (STAGE_BYTES + 16) + (2 + chunks) * TILE_BYTES;
}

struct AttnParams {
  CUtensorMap ln;    // 3-D (c, s, b·f), box 64 x L x f
  CUtensorMap om;    // o (inner, s, b·f): the store of a full 64-column chunk of a head
  CUtensorMap w[3];  // wq, wk, wv: (c cols, inner rows), box 64 x 64
  bf16* o;           // (b, f, s, inner)
  int f, s, c, inner, heads, d, L, chunks, nk, loc_tiles, items, stages;
  float scale_log2;  // log2(e) / √d
};

// Step g of this block's stream: item blockIdx.x + (g / per)·gridDim.x,
// chunk (g % per) / nk, K step g % nk (one thread).
__device__ __forceinline__ void attn_load_step(const AttnParams& p, const Ring& ring, int g) {
  const int per = p.chunks * p.nk;
  const int item = blockIdx.x + (g / per) * gridDim.x;
  const int j = (g % per) / p.nk, kb = g % p.nk;
  const int tile = item / p.heads, h = item % p.heads;
  const int bi = tile / p.loc_tiles, s0 = (tile % p.loc_tiles) * p.L;
  const uint32_t st = ring.stage(g), bar = ring.acquire(g, 128 * p.L * p.f + 3 * W_BYTES);
  tma_load_3d(st, &p.ln, bar, kb * 64, s0, bi * p.f);
#pragma unroll
  for (int m = 0; m < 3; ++m)
    tma_load_3d(st + A_BYTES + m * W_BYTES, &p.w[m], bar, kb * 64, h * p.d + 64 * j, 0);
}

// A 128-row tile of 64 columns in the 128-byte swizzle: q, k, a v chunk, o.
using Tile64 = HeadChunks<64>;

__global__ void __launch_bounds__(THREADS, 1)
temporal_block_attention_kernel(const __grid_constant__ AttnParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages;
  const uint32_t qt = base + stages * STAGE_BYTES, kt = qt + TILE_BYTES, vt = kt + TILE_BYTES;
  const uint32_t full = vt + p.chunks * TILE_BYTES, empty = full + 8 * stages;
  uint8_t* q_ptr = smem_raw + (qt - raw);
  uint8_t* k_ptr = smem_raw + (kt - raw);
  uint8_t* v_ptr = smem_raw + (vt - raw);
  const Ring ring{base, full, empty, static_cast<uint32_t>(STAGE_BYTES), stages};
  const int tid = threadIdx.x;
  const int rows = p.L * p.f;  // real rows of a tile

  // The A rows past L·f of every stage are never written by TMA: zero them
  // once, so q, k, v there are zeros.
  for (int i = tid; i < stages * (ROWS - rows) * 8; i += THREADS) {
    const int sidx = i / ((ROWS - rows) * 8), u = i % ((ROWS - rows) * 8);
    *reinterpret_cast<uint4*>(smem_raw + (base - raw) + sidx * STAGE_BYTES + rows * 128 + u * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  if (tid == 0) {
    ring.init(THREADS);
    fence_barrier_init();
  }
  __syncthreads();

  const int per = p.chunks * p.nk;
  const int steps = (blockIdx.x < p.items ? (p.items - 1 - blockIdx.x) / gridDim.x + 1 : 0) * per;
  // Thread 0 loads too: the first `stages` steps, then at each release the
  // step `stages` later into the released stage.
  if (tid == 0)
    for (int g = 0; g < steps && g < stages; ++g) attn_load_step(p, ring, g);
  __syncwarp();
  auto release = [&](int g) {
    ring.release(g);
    if (tid == 0 && g + stages < steps) attn_load_step(p, ring, g + stages);
    __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
  };

  const int wg = tid / 128, lt = tid % 128, t = lt & 3, g8 = (lt & 31) / 4;
  const int r0 = 64 * wg + (lt / 32) * 16 + g8;  // the thread's first row of the tile
  // Per row of the thread (r0, r0 + 8): its location and frame, and which
  // of its 32 score columns (n8 block j, element e: key 8j + 2t + e) are
  // keys of the same location.
  int loc[2], frame[2];
  uint32_t keys[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    loc[h] = r % p.L;
    frame[h] = r / p.L;
    keys[h] = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < rows && col % p.L == loc[h]) keys[h] |= 1u << (2 * j + e);
      }
  }

  float acc[96], sc[64], oacc[32];
  uint32_t pa[8][4];
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int tile = item / p.heads, hd = item % p.heads;
    const int bi = tile / p.loc_tiles, s0 = (tile % p.loc_tiles) * p.L;
    for (int j = 0; j < p.chunks; ++j) {
      // ---- q‖k‖v of chunk j: 64 rows x 192 columns a warpgroup ----------
      // (the accumulators are zeroed so the last chunk's values, which the
      // asm operands would read, are dead through the attention phase)
#pragma unroll
      for (int x = 0; x < 96; ++x) acc[x] = 0.f;
      for (int kb = 0; kb < p.nk; ++kb, ++it) {
        const uint32_t st = ring.stage(it);
        ring.wait_full(it);
        fence_all<96>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<192>(acc, desc_k_major(st + wg * 64 * 128 + 32 * kk, 128),
                        desc_k_major(st + A_BYTES + 32 * kk, 128), kb + kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_all<96>(acc);
        if (kb > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_all<96>(acc);
      release(it - 1);
      if (tid == 0) bulk_wait_read();  // the last store of o has read the q and k tiles
      named_bar_sync(1, THREADS);
      // q, k, v to shared memory in bf16; columns past d are zeros
      const int live = p.d - 64 * j;
#pragma unroll
      for (int jj = 0; jj < 24; ++jj) {
        const int col = 8 * (jj % 8) + 2 * t;
        uint8_t* dst = jj < 8 ? q_ptr : jj < 16 ? k_ptr : v_ptr + j * TILE_BYTES;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(dst + out_offset<Tile64>(r0 + 8 * h, col)) =
              col < live ? pack_bf16(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]) : 0u;
      }
      fence_proxy_async();
      named_bar_sync(1, THREADS);  // both warpgroups' q, k, v rows are written
      // ---- S += q·kᵀ over the whole tile: 64 rows x 128 keys ------------
      if (j == 0) {
#pragma unroll
        for (int x = 0; x < 64; ++x) sc[x] = 0.f;
      }
      fence_all<64>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<128>(sc, desc_k_major(qt + wg * 64 * 128 + 32 * kk, 128),
                      desc_k_major(kt + 32 * kk, 128), j > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all<64>(sc);
      named_bar_sync(1, THREADS);  // both have read q and k before the next chunk writes them
    }
    // ---- softmax over the keys of the row's location ---------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[4 * j + 2 * h + e];
          v = (keys[h] >> (2 * j + e)) & 1u ? v : -CUDART_INF_F;
          m = fmaxf(m, v);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float ms = m * p.scale_log2;  // the largest scaled score (the scale is > 0)
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[4 * j + 2 * h + e];
          v = exp2_ftz(fmaf(v, p.scale_log2, -ms));  // masked keys: exp2(-inf) = 0
          sum += v;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        pa[j / 2][2 * (j & 1) + h] =
            pack_bf16(sc[4 * j + 2 * h] * inv, sc[4 * j + 2 * h + 1] * inv);
    }
    // ---- o = P·v, chunk by chunk, to device memory: a chunk of 64 columns
    // of the head through the q or k tile (free after S) and one TMA store,
    // a narrower last chunk (d % 64 != 0) from registers ------------------
    for (int j = 0; j < p.chunks; ++j) {
#pragma unroll
      for (int x = 0; x < 32; ++x) oacc[x] = 0.f;
      fence_all<32>(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_tb<64>(oacc, pa[kk], desc_mn_major(vt + j * TILE_BYTES + kk * 16 * 128, 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_all<32>(oacc);
      const int live = p.d - 64 * j;
      if (live >= 64) {
        uint8_t* ob = j & 1 ? k_ptr : q_ptr;
        if (j >= 2) {  // the store of chunk j − 2 has read this tile
          if (tid == 0) bulk_wait_read();
          named_bar_sync(1, THREADS);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(ob + out_offset<Tile64>(r0 + 8 * h, 8 * jj + 2 * t)) =
                pack_bf16(oacc[4 * jj + 2 * h], oacc[4 * jj + 2 * h + 1]);
        fence_proxy_async();
        named_bar_sync(1, THREADS);
        if (tid == 0) {  // the tile's L·f rows; locations past s are not written
          tma_store_3d(&p.om, j & 1 ? kt : qt, hd * p.d + 64 * j, s0, bi * p.f);
          bulk_commit();
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = s0 + loc[h];
        if (r0 + 8 * h >= rows || sl >= p.s) continue;
        bf16* dst =
            p.o + (((size_t)bi * p.f + frame[h]) * p.s + sl) * p.inner + hd * p.d + 64 * j;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = 8 * jj + 2 * t;
          if (col < live)
            *reinterpret_cast<uint32_t*>(dst + col) =
                pack_bf16(oacc[4 * jj + 2 * h], oacc[4 * jj + 2 * h + 1]);
        }
      }
    }
    named_bar_sync(1, THREADS);  // both have read v before the next item writes it
  }
  if (tid == 0) bulk_wait();
}

}  // namespace
}  // namespace aat

// x, y: (b, f, s, c) bf16; wq, wk, wv: (inner, c) and wo: (c, inner) bf16 in
// the torch Linear layout (out, in); ln_s, ln_b, bo: (c,) fp32; ln: (b, f,
// s, c) and o: (b, f, s, inner) bf16 scratch.  heads·d == inner: all of c,
// or a tensor-parallel rank's slice of whole heads; d % 8 == 0, d <= 256,
// c <= 2048, 1 <= f <= 128.  partial != 0: the out-projection without bo
// and x (the rank's share of Wo·attn, which the ranks sum before adding
// them once; bo unread).
// The launch plan (ops/temporal_block.py::launch_plan): locations a tile L,
// the attention kernel's ring stages, grid and shared bytes; the
// out-projection's tile width, stages, grid and shared bytes (kernel 2's
// residual GEMM, ops/geglu.py::gemm_plan).
AAT_EXPORT int aat_temporal_block(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wq, const void* wk, const void* wv, const void* wo,
                                  const void* bo, void* ln, void* o, void* y, int b, int f, int s,
                                  int c, int inner, int heads, int partial, float eps, int L,
                                  int stages, int grid, int smem, int bn_out, int stages_out,
                                  int grid_out, int smem_out, void* stream) {
  using namespace aat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || f < 1 || f > ROWS || heads < 1 || inner % heads != 0 || c > 2048 ||
      inner > c || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = inner / heads, n = b * f * s;
  const int chunks = (d + 63) / 64;
  if (d % 8 != 0 || chunks > MAX_CHUNKS || L < 1 || L * f > ROWS || stages < 2 || grid < 1 ||
      smem < attention_smem(stages, chunks) || smem > gemm::SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);

  int err = gemm::launch_layer_norm<temporal_block>(x, ln_s, ln_b, ln, n, c, c, eps, st);
  if (err) return err;

  AttnParams p = {};
  p.o = static_cast<bf16*>(o);
  p.f = f;
  p.s = s;
  p.c = c;
  p.inner = inner;
  p.heads = heads;
  p.d = d;
  p.L = L;
  p.chunks = chunks;
  p.nk = (c + 63) / 64;
  p.loc_tiles = (s + L - 1) / L;
  p.items = b * p.loc_tiles * heads;
  p.stages = stages;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  const uint64_t ldims[3] = {(uint64_t)c, (uint64_t)s, (uint64_t)b * f};
  const uint32_t lbox[3] = {64, (uint32_t)L, (uint32_t)f};
  const uint64_t odims[3] = {(uint64_t)inner, (uint64_t)s, (uint64_t)b * f};
  err = hopper::make_map(&p.ln, ln, 3, ldims, lbox);
  if (!err) err = hopper::make_map(&p.om, o, 3, odims, lbox);
  const void* ws[3] = {wq, wk, wv};
  for (int m = 0; m < 3 && !err; ++m)
    err = hopper::make_map_3d(&p.w[m], ws[m], c, inner, 1, 64, 64);
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(temporal_block_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  temporal_block_attention_kernel<<<grid, THREADS, smem, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  return gemm::gemm_bias_residual<temporal_block>(o, wo, partial ? nullptr : bo,
                                                  partial ? nullptr : x, y, n, c, inner, bn_out,
                                                  stages_out, grid_out, smem_out, st);
}
