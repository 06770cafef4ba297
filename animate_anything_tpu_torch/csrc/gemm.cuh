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
// rows, and a tree of tickets adds those partials into Σy, Σy² in one fixed
// order (below), whatever order the tiles finish in.
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

// ---- fixed-order slab sums (kernels 3 and 4) ------------------------------------

// Σy, Σy² per (slab, column) of a stored output, in one fixed order of
// additions, whatever order the tiles finish in (fp32 atomics added the
// tiles' partials in finishing order, so identical calls differed).  Each
// 64-row sub-tile of a slab writes its per-column partial sums into `part`
// in its epilogue; after its last tile each warp takes its sub-tiles'
// tickets (kernel 6's pattern, group_norm.cu), and a two-level tree adds
// the partials up, a warp's 64 columns at a time:
// - level 1: the sub-tiles of a slab in groups of FAN consecutive ones; the
//   last warp to arrive for its (slab, group, output chunk, warp) adds the
//   group's partials in sub-tile order;
// - level 2: the last group to finish a (slab, chunk, warp) adds the
//   groups' sums in group order into s1, s2 (a slab of one group stores its
//   level-1 sum there directly, one of one sub-tile its partial).
// A ticket a tile would cost the tile loop a fence and a round trip each
// time, and one sequential fold of a 64-sub-tile slab (s = 4096) 64
// dependent L2 reads; taken at the end, a warp's tickets are one fence and
// one round trip a level (a lane a sub-tile), and each fold reads at most
// FAN partials a column, all in flight at once, FOLDS folds at a time.  The
// last arriver of each level resets its ticket.
constexpr int FAN = 8;

// The scratch of the slab sums below for `slabs` slabs of s rows and n
// columns in `chunks` output chunks: the fp32 elements of `part` (0 where a
// slab is one sub-tile and no partials are written) and the ints of
// `tickets`.  The wrappers size their buffers from it (aat_slab_sums_sizes),
// so this is the layout's one owner.
inline void slab_sums_sizes(int slabs, int s, int n, int chunks, long long* part,
                            long long* tickets) {
  const long long subs = (s + 63) / 64, groups = (subs + FAN - 1) / FAN;
  *part = subs > 1 ? 2 * slabs * (subs + groups) * n : 0;
  *tickets = slabs * (groups + 1) * chunks * 4;
}

struct SlabSums {
  float* s1;      // (slabs, n) fp32
  float* s2;
  float* part;    // (2, slabs, subs_per_slab + groups, n) fp32: partials, then group sums
  int* tickets;   // (slabs·groups + slabs)·chunks·4, zeroed, left zeroed
  int slabs, subs_per_slab, chunks;
  __device__ __forceinline__ int groups() const { return (subs_per_slab + FAN - 1) / FAN; }
  __device__ __forceinline__ size_t row(int slab, int r) const {  // r: a sub-tile or subs + group
    return (size_t)slab * (subs_per_slab + groups()) + r;
  }
  __device__ __forceinline__ float* part2(int n) const {  // the Σy² half of `part`
    return part + (size_t)slabs * (subs_per_slab + groups()) * n;
  }
};

// A warp's sub-tile whose partials it wrote (slab < 0: none): output chunk
// `chunk` of the kernel's chunk width.
struct SumsSlot {
  int slab, sub, chunk;
};

// Whether the calling warp (of a warpgroup's 4) writes partials for output
// chunk `chunk` of `width` columns: it has columns there, and slabs have
// more than one sub-tile.
__device__ __forceinline__ bool warp_sums(const SlabSums& ss, int n, int chunk, int width,
                                          int warp) {
  return ss.subs_per_slab > 1 && 64 * warp < width && chunk * width + 64 * warp < n;
}

// Thread lt of the calling warpgroup holds (a0, a1) = Σy and (q0, q1) = Σy²
// of columns j0 + 2·lt, + 1 over sub-tile `sub` of slab `slab`, for output
// chunk `chunk` of `width` columns from j0 = chunk·width: written to `part`
// (or, for a one-sub-tile slab, to s1, s2).
__device__ __forceinline__ void slab_sums_write(const SlabSums& ss, int n, int slab, int sub,
                                                int chunk, int width, int lt, float a0, float a1,
                                                float q0, float q1) {
  const int col = chunk * width + 2 * lt;
  if (2 * lt >= width || col >= n) return;
  if (ss.subs_per_slab == 1) {
    *reinterpret_cast<float2*>(ss.s1 + (size_t)slab * n + col) = make_float2(a0, a1);
    *reinterpret_cast<float2*>(ss.s2 + (size_t)slab * n + col) = make_float2(q0, q1);
    return;
  }
  const size_t at = ss.row(slab, sub) * n + col;
  *reinterpret_cast<float2*>(ss.part + at) = make_float2(a0, a1);
  *reinterpret_cast<float2*>(ss.part2(n) + at) = make_float2(q0, q1);
}

// Up to FAN rows r0 .. r0 + count − 1 of `part`'s Σy and Σy² halves at
// column col: load() issues every load, sum() adds them in row order, so
// the loads of FOLDS folds are in flight together.
struct RowFold {
  float2 u[FAN], v[FAN];
  int count;
  __device__ __forceinline__ void load(const SlabSums& ss, int n, int slab, int r0, int cnt,
                                       int col) {
    count = cnt;
#pragma unroll
    for (int j = 0; j < FAN; ++j) {
      const size_t at = ss.row(slab, r0 + min(j, cnt - 1)) * n + col;
      u[j] = __ldcg(reinterpret_cast<const float2*>(ss.part + at));
      v[j] = __ldcg(reinterpret_cast<const float2*>(ss.part2(n) + at));
    }
  }
  __device__ __forceinline__ void sum(float2& s, float2& q) const {
    s = make_float2(0.f, 0.f);
    q = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < FAN; ++j) {
      if (j < count) {
        s.x += u[j].x;
        s.y += u[j].y;
        q.x += v[j].x;
        q.y += v[j].y;
      }
    }
  }
};

// Folds whose loads a warp keeps in flight together: four made kernel 4 spill
// at its 168 registers (384 threads) and ran slower than two.
constexpr int FOLDS = 2;

// The next (at most) FOLDS slots of `mask` (lanes holding slots in `mine`),
// taken off it: their count.  `mask` is the same in all lanes.
__device__ __forceinline__ int next_slots(unsigned& mask, const SumsSlot& mine,
                                          SumsSlot (&sl)[FOLDS]) {
  int k = 0;
  for (; k < FOLDS && mask; ++k) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    sl[k] = SumsSlot{__shfl_sync(0xffffffffu, mine.slab, j), __shfl_sync(0xffffffffu, mine.sub, j),
                     __shfl_sync(0xffffffffu, mine.chunk, j)};
  }
  return k;
}

__device__ __forceinline__ void store_sums(float* s1, float* s2, size_t at, float2 s, float2 q) {
  *reinterpret_cast<float2*>(s1 + at) = s;
  *reinterpret_cast<float2*>(s2 + at) = q;
}

// Level 1 for every slot of `mask`, whose level-1 ticket this warp took
// last: its group's partials in sub-tile order into the group's row of
// `part` (a slab of one group: into s1, s2), FOLDS slots at a time.
__device__ __forceinline__ void fold_groups(const SlabSums& ss, int n, int width, unsigned mask,
                                            const SumsSlot& mine, int lt) {
  const int groups = ss.groups();
  while (mask) {
    SumsSlot sl[FOLDS];
    const int k = next_slots(mask, mine, sl);
    RowFold f[FOLDS];
#pragma unroll
    for (int i = 0; i < FOLDS; ++i) {
      const int col = sl[i].chunk * width + 2 * lt, group = sl[i].sub / FAN;
      if (i < k && 2 * lt < width && col < n)
        f[i].load(ss, n, sl[i].slab, group * FAN, min(FAN, ss.subs_per_slab - group * FAN), col);
    }
#pragma unroll
    for (int i = 0; i < FOLDS; ++i) {
      const int col = sl[i].chunk * width + 2 * lt, group = sl[i].sub / FAN;
      if (i < k && 2 * lt < width && col < n) {
        float2 s, q;
        f[i].sum(s, q);
        if (groups == 1)
          store_sums(ss.s1, ss.s2, (size_t)sl[i].slab * n + col, s, q);
        else
          store_sums(ss.part, ss.part2(n), ss.row(sl[i].slab, ss.subs_per_slab + group) * n + col,
                     s, q);
      }
    }
  }
}

// Level 2 for every slot of `mask`, whose slab's level-2 ticket this warp
// took last: the slab's group sums in group order into s1, s2, FOLDS slots
// at a time.
__device__ __forceinline__ void fold_slabs(const SlabSums& ss, int n, int width, unsigned mask,
                                           const SumsSlot& mine, int lt) {
  const int groups = ss.groups();
  while (mask) {
    SumsSlot sl[FOLDS];
    const int k = next_slots(mask, mine, sl);
    float2 st[FOLDS] = {}, qt[FOLDS] = {};
    for (int g0 = 0; g0 < groups; g0 += FAN) {
      RowFold f[FOLDS];
#pragma unroll
      for (int i = 0; i < FOLDS; ++i) {
        const int col = sl[i].chunk * width + 2 * lt;
        if (i < k && 2 * lt < width && col < n)
          f[i].load(ss, n, sl[i].slab, ss.subs_per_slab + g0, min(FAN, groups - g0), col);
      }
#pragma unroll
      for (int i = 0; i < FOLDS; ++i) {
        const int col = sl[i].chunk * width + 2 * lt;
        if (i < k && 2 * lt < width && col < n) {
          float2 s, q;
          f[i].sum(s, q);
          st[i].x += s.x;
          st[i].y += s.y;
          qt[i].x += q.x;
          qt[i].y += q.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FOLDS; ++i) {
      const int col = sl[i].chunk * width + 2 * lt;
      if (i < k && 2 * lt < width && col < n)
        store_sums(ss.s1, ss.s2, (size_t)sl[i].slab * n + col, st[i], qt[i]);
    }
  }
}

// After the calling warp's last tile: the level-1 tickets of its `count`
// slots, slot_of(i) (slab < 0 where it wrote none), one lane a slot; the
// folds of the groups it took last; one fence, then those groups' level-2
// tickets, a lane a slot again, and the folds of the slabs it took last.
// The tickets and fences are taken once for all of a warp's slots, and the
// folds' loads run FOLDS slots at a time: the last warps to finish fold most
// groups, so the tail is what each fold waits for.  All 32 lanes call it.
template <typename SlotOf>
__device__ __forceinline__ void slab_sums_finish(const SlabSums& ss, int n, int width, int count,
                                                 SlotOf slot_of, int lt) {
  const int warp = lt >> 5, lane = lt & 31, groups = ss.groups();
  __threadfence();  // this warp's partials before any of its tickets
  __syncwarp();
  for (int base = 0; base < count; base += 32) {
    SumsSlot mine{-1, 0, 0};
    if (base + lane < count) mine = slot_of(base + lane);
    bool last = false;
    if (mine.slab >= 0) {
      const int group = mine.sub / FAN;
      int* t1 = ss.tickets +
                (((size_t)mine.slab * groups + group) * ss.chunks + mine.chunk) * 4 + warp;
      last = atomicAdd(t1, 1) == min(FAN, ss.subs_per_slab - group * FAN) - 1;
      if (last) *t1 = 0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, last);
    if (!mask) continue;
    __threadfence();
    fold_groups(ss, n, width, mask, mine, lt);
    if (groups == 1) continue;
    __threadfence();  // the group sums before their level-2 tickets
    __syncwarp();
    bool last2 = false;
    if (last) {
      int* t2 = ss.tickets + (size_t)ss.slabs * groups * ss.chunks * 4 +
                ((size_t)mine.slab * ss.chunks + mine.chunk) * 4 + warp;
      last2 = atomicAdd(t2, 1) == groups - 1;
      if (last2) *t2 = 0;
    }
    const unsigned mask2 = __ballot_sync(0xffffffffu, last2);
    if (!mask2) continue;
    __threadfence();
    fold_slabs(ss, n, width, mask2, mine, lt);
  }
}

// ---- the GEMMs ------------------------------------------------------------------

struct GemmParams {
  CUtensorMap a;       // (k cols, m rows) bf16, box 64 x BM
  CUtensorMap b;       // (k cols, weight rows) bf16, box 64 x (GEGLU ? BN/2 : BN)
  CUtensorMap out[2];  // (n cols, m rows) bf16, boxes 64 and 32 columns x 64 rows
  CUtensorMap res[2];  // the residual, as `out` (the residual form only)
  const float* bias;   // GEGLU: b1 (8c, val then gate); else the output bias (n)
  int partial;         // the residual form without bias and residual: y = a·wᵀ alone
  int m, n, k;         // rows, output columns (GEGLU: act's 4c), reduction
  int gate_row0;       // GEGLU: the W1 row (and b1 entry) of gate column 0, 4c
  int col_tiles, tiles, stages;
  int s, subs_per_slab, subs;  // the slab form: rows a slab, 64-row sub-tiles a slab, in all
  SlabSums sums;               // the slab form: Σy, Σy² per (slab, column)
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
// over the residual tile already in `out`, in place, or y = acc alone in the
// partial form (a tensor-parallel rank's share, summed over the ranks before
// the bias and the residual are added once).  Rows are the thread's two of
// the warpgroup's 64.
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
    const float2 bv = (GEGLU || !p.partial) ? *reinterpret_cast<const float2*>(p.bias + bc)
                                            : make_float2(0.f, 0.f);
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
        const float2 x =
            p.partial ? make_float2(0.f, 0.f)
                      : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
        *dst = pack_bf16(v[0] + bv.x + x.x, v[1] + bv.y + x.y);
      }
    }
  }
}

// The slab form's Σy, Σy² of the warpgroup's stored output tile `out`
// (OUT columns from j0, `rows` rows of sub-tile `sub` of slab `slab`): two
// columns a thread, written as the sub-tile's partials (slab_sums_write).
template <typename Chunks, int OUT>
__device__ __forceinline__ void column_sums(const GemmParams& p, const uint8_t* out, int j0,
                                            int ct, int slab, int sub, int rows, int lt) {
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
  slab_sums_write(p.sums, p.n, slab, sub, ct, OUT, lt, a0, a1, q0, q1);
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
        if (me.on && !p.partial) {
          mbar_expect_tx(res_bar, L::OUT_BYTES);
#pragma unroll
          for (int i = 0; i < Chunks::COUNT; ++i)
            tma_load_3d(out + Chunks::offset(i, 64), &p.res[Chunks::kind(i)], res_bar,
                        j0 + Chunks::col(i), row0, me.slab);
        } else {
          mbar_arrive(res_bar);  // no sub-tile or no residual: complete the phase
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
      if (me.on)
        column_sums<Chunks, L::OUT>(p, out_ptr, j0, ct, me.slab, row0 / 64, min(64, p.s - row0),
                                    lt);
      named_bar_sync(1 + wg, 128);  // the sums have read the tile before the next residual load
    }
  }
  if constexpr (SLABS) {  // the tickets of this warp's sub-tiles, one a tile
    const int count = blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    slab_sums_finish(p.sums, p.n, L::OUT, count, [&](int i) {
      const int tile = blockIdx.x + i * gridDim.x, ct = tile % p.col_tiles;
      const SlabRows r = slab_rows(p, tile / p.col_tiles, wg);
      return r.on && warp_sums(p.sums, p.n, ct, L::OUT, lt >> 5) ? SumsSlot{r.slab, r.s0 / 64, ct}
                                                                : SumsSlot{-1, 0, 0};
    }, lt);
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
// width bn in 256, 160, 128, 64 (the launch plan's, ops/geglu.py::gemm_plan);
// with bias and res both null, the partial form y = a·wᵀ.
template <typename Owner>
int gemm_bias_residual(const void* a, const void* w, const void* bias, const void* res, void* y,
                       int m, int n, int k, int bn, int stages, int grid, int smem,
                       cudaStream_t stream) {
  if ((bias == nullptr) != (res == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p = {};
  p.bias = static_cast<const float*>(bias);
  p.partial = res == nullptr;
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
// res with Σy, Σy² of the stored y per (slab, column) written into s1, s2
// (slabs, n) in fixed order through `part` (2·slabs·(subs + groups)·n fp32
// scratch where s > 64: subs = ⌈s/64⌉ sub-tiles a slab, groups = ⌈subs/FAN⌉)
// and `tickets` (slabs·(groups + 1)·⌈n/bn⌉·4 zeroed ints, left zeroed).
// Tile width bn in 256, 160, 128, 64 (the launch plan's,
// ops/proj_residual.py::launch_plan).
template <typename Owner>
int gemm_bias_residual_stats(const void* a, const void* w, const void* bias, const void* res,
                             void* y, float* s1, float* s2, float* part, int* tickets, int slabs,
                             int s, int n, int k, int bn, int stages, int grid, int smem,
                             cudaStream_t stream) {
  if (slabs < 1 || s < 1 || res == nullptr || tickets == nullptr ||
      (s > 64 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p = {};
  p.bias = static_cast<const float*>(bias);
  p.m = slabs * s;
  p.n = n;
  p.k = k;
  p.s = s;
  p.subs_per_slab = (s + 63) / 64;
  p.subs = slabs * p.subs_per_slab;
  p.col_tiles = (n + bn - 1) / bn;
  p.tiles = (p.subs + 1) / 2 * p.col_tiles;
  p.sums = SlabSums{s1, s2, part, tickets, slabs, p.subs_per_slab, p.col_tiles};
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
