// Kernel 3: one TemporalConvLayer stage, GroupNorm-apply -> SiLU -> 3-tap
// frame conv (+ residual), with a per-(batch, frame, channel) Σy / Σy²
// epilogue of the stored output, on TMA and wgmma.
//
// Replaces animate_anything_tpu/ops/temporal_conv.py::_pallas_stage
// (_kernel).  Per output row (b, f, s):
//     y = Σ_{t=-1..1} SiLU(a_b·x[b, f+t, s] + b_b)·W_t + bias (+ residual)
// with zero frames past both ends.  The GroupNorm statistics are already
// folded into the per-(batch, channel) affine (a, b) by group_affine.
//
// Bound on the H100: tensor-core math (6·cin·cout flops per row against
// (cin + cout)·2 bytes; 0.087 ms at the UNet's large sites).  Design: the
// three taps are one GEMM with K = 3·cin over the weight packed as (cout,
// 3·cin), K-major, on the skeleton of kernel 2's persistent TMA + wgmma
// GEMM (gemm.cuh): a ring of 64-column K stages on full/empty mbarriers
// (hopper.cuh's Ring), two consumer warpgroups of 64 rows, the persistent
// tile walk with the column tile fastest:
// - M is 64-row sub-tiles of one (batch, frame) slab; a 128-row block tile
//   is two consecutive sub-tiles, one a consumer warpgroup, so s = 64 (the
//   c = 1280 site) fills whole tiles with two slabs.  Each warpgroup's A
//   box is raw x of its tap frame, TMA-loaded over a 4-D map (cin, s, f,
//   b), so rows past s read as zeros and no box reaches another slab;
// - the affine + SiLU is applied on chip: each consumer warpgroup rewrites
//   its 64 A rows of the stage in place (fp32 affine, the tanh-identity
//   SiLU 0.5·z·(1 + tanh(z/2)) of the TPU kernel, bf16), then
//   fence.proxy.async makes them visible to wgmma; the activation never
//   exists in device memory.  With tanh(z/2) = 1 − 2/(1 + e^z) it is
//   z − z/(1 + e^z): one ex2, one reciprocal and one FMA after the affine,
//   where tanhf took some twenty instructions (the activation, redone for
//   each column tile, bounded the first version more than the tensor
//   cores did).  A thread's four 16-byte units of a stage all hold the
//   same 8 channels (the 128-byte swizzle XORs the unit with the row's low
//   3 bits, and the thread's rows are 16 apart), so it reads its (a, b)
//   once a step;
// - a tap whose frame lies past the ends is JAX's zero frame: its A rows
//   are written as zeros, and where neither sub-tile of a tile needs the
//   tap (every tile with s >= 128) its K steps are skipped, no load and no
//   product;
// - a tile is BN = NACC x NB output columns: one m64nNBk16 wgmma a k16
//   step for each of NACC = 2 accumulators, all over the same A rows.
//   BN = 320 (two accumulators of 160), so each A element is activated
//   once (c = 320) or twice (c = 640) where 160-column tiles did it twice
//   and four times, and the L2 bytes a flop drop with it; where 320-column
//   tiles number fewer than the SMs the plan takes BN = 256 (s = 64, c =
//   1280: 68 tiles of 320 would leave half the SMs idle).  A narrower cout
//   runs in the same tiles: TMA zero-fills the weight rows past cout, and
//   those columns are neither stored nor summed.  B is the packed weight's
//   BN x 64 box (one TMA box for each accumulator), shared by both
//   warpgroups;
// - no producer warp: the accumulators (160 registers at BN = 320) need
//   the 255 a thread of a 256-thread block has, so the first thread issues
//   the loads, refilling each stage as it is released (kernel 2's BN = 256
//   form).  Refilling without waiting for the other warpgroup (issuing a
//   stage's step only once it was free) was slower: the loads went out
//   later;
// - the epilogue, one accumulator at a time: y = acc + bias (+ the
//   residual, prefetched into L2 by TMA at the tile's start and read from
//   there) in fp32, rounded to bf16 into the warpgroup's 64 x NB output
//   tile in TMA's swizzle and stored with one TMA store; then each thread
//   sums two columns of the stored tile over the sub-tile's rows into the
//   sub-tile's partials, which gemm.cuh's tree of tickets adds in one fixed
//   order after the last tile (slab_sums_write / slab_sums_finish): Σy, Σy²
//   have one order, as the TPU kernel's, accumulated across a sequential
//   grid axis, had, though tiles finish in no order.  Writing y and the
//   sums straight from registers (16-byte pieces, an atomic per column and
//   warp) took half the time of a tile's mainloop again.
// Tiles, ring depth, grid and shared-memory bytes come from the wrapper's
// launch plan (ops/temporal_conv.py::launch_plan), checked here.  The TPU's
// c <= 640 gate was a VMEM limit: this kernel runs at every width.
#include "gemm.cuh"

namespace aat {
namespace {

using namespace hopper;
using gemm::CONSUMERS;

constexpr int SUB = 64;                // rows of a sub-tile (one warpgroup's)
constexpr int NACC = 2;                // accumulators a tile, NB columns each
constexpr int HALF_BYTES = SUB * 128;  // its A rows of a 64-column K step

// A tile of BN = NACC·NB output columns: the ring of 64-column K stages (A:
// two 64-row sub-tiles, B: BN weight rows), each consumer warpgroup's 64 x
// NB output tile (one accumulator's columns, as 64- and 32-column chunks in
// the TMA swizzle), then the full and empty barriers.
template <int NB>
struct TapLayout {
  static constexpr int BN = NB * NACC;
  using Chunks = HeadChunks<NB>;
  static constexpr int A_BYTES = 2 * HALF_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + BN * 128;
  static constexpr int OUT_BYTES = SUB * NB * 2;
  static constexpr int smem(int stages) {
    return 1024 + stages * (STAGE_BYTES + 16) + 2 * OUT_BYTES;
  }
  static_assert(NB % 32 == 0, "output chunks of 64 and 32 columns");
};

struct TapParams {
  CUtensorMap x;       // 4-D (cin, s, f, bsz) bf16, box 64 x 64 x 1 x 1
  CUtensorMap w;       // (3·cin cols, cout rows) bf16, box 64 x NB
  CUtensorMap out[2];  // 4-D (cout, s, f, bsz) bf16, boxes 64 and 32 columns x 64 rows
  CUtensorMap res;     // the residual, as out[0] (L2 prefetch only)
  const bf16* r;       // the residual (bsz, f, s, cout) or null
  const float* a;      // (bsz, cin) fp32
  const float* sh;     // (bsz, cin) fp32
  const float* bias;   // (cout,) fp32
  gemm::SlabSums sums;  // Σy, Σy² per (bsz·f slab, cout)
  int f, s, cin, cout;
  int subs_per_slab, subs;  // 64-row sub-tiles a (batch, frame) slab; in all
  int col_tiles, tiles, nkc, stages;
};

// One warpgroup's sub-tile of a block tile.
struct Half {
  bool on;  // the sub-tile exists (the last tile of an odd count has one)
  int slab, bi, fi, s0;
};

__device__ __forceinline__ Half half_of(const TapParams& p, int tile, int h) {
  const int sub = 2 * (tile / p.col_tiles) + h;
  Half r;
  r.on = sub < p.subs;
  r.slab = r.on ? sub / p.subs_per_slab : 0;
  r.bi = r.slab / p.f;
  r.fi = r.slab % p.f;
  r.s0 = (sub % p.subs_per_slab) * SUB;
  return r;
}

// The sub-tile reads frame fi + tap − 1 for this tap.
__device__ __forceinline__ bool tap_on(const TapParams& p, const Half& h, int tap) {
  const int fr = h.fi + tap - 1;
  return h.on && fr >= 0 && fr < p.f;
}

// The producer's walk over this block's K steps: tiles blockIdx.x,
// + gridDim.x, ...; in each the taps either sub-tile needs; in each tap the
// nkc 64-column steps of cin.  The consumers walk the same steps in loops.
struct TapCursor {
  int tile, tap, kb;
  Half h0, h1;

  __device__ __forceinline__ bool valid(const TapParams& p) const { return tile < p.tiles; }
  __device__ __forceinline__ bool live(const TapParams& p) const {
    return tap_on(p, h0, tap) || tap_on(p, h1, tap);
  }
  __device__ __forceinline__ void next_tap(const TapParams& p) {
    if (++tap < 3) return;
    tap = 0;
    tile += gridDim.x;
    if (valid(p)) {
      h0 = half_of(p, tile, 0);
      h1 = half_of(p, tile, 1);
    }
  }
  __device__ __forceinline__ void settle(const TapParams& p) {
    while (valid(p) && !live(p)) next_tap(p);
  }
  __device__ __forceinline__ void start(const TapParams& p) {
    tile = blockIdx.x - gridDim.x;
    tap = 2;
    kb = 0;
    next_tap(p);
    settle(p);
  }
  __device__ __forceinline__ void advance(const TapParams& p) {
    if (++kb < p.nkc) return;
    kb = 0;
    next_tap(p);
    settle(p);
  }
};

// Step g (the cursor's) into its stage: each sub-tile's A box where its
// tap frame exists, and the B box (one thread).
template <int NB>
__device__ __forceinline__ void tap_load_step(const TapParams& p, const Ring& ring,
                                              const TapCursor& c, int g) {
  using L = TapLayout<NB>;
  const bool on0 = tap_on(p, c.h0, c.tap), on1 = tap_on(p, c.h1, c.tap);
  const uint32_t tx = (on0 + on1) * HALF_BYTES + L::BN * 128;
  const uint32_t st = ring.stage(g), bar = ring.acquire(g, tx);
  const int k0 = c.kb * 64;
  if (on0) tma_load_4d(st, &p.x, bar, k0, c.h0.s0, c.h0.fi + c.tap - 1, c.h0.bi);
  if (on1) tma_load_4d(st + HALF_BYTES, &p.x, bar, k0, c.h1.s0, c.h1.fi + c.tap - 1, c.h1.bi);
#pragma unroll
  for (int a = 0; a < NACC; ++a)
    tma_load_3d(st + L::A_BYTES + a * NB * 128, &p.w, bar, c.tap * p.cin + k0,
                (c.tile % p.col_tiles) * L::BN + a * NB, 0);
}

// The warpgroup's 64 A rows of a stage, in place: SiLU(a·x + b) in bf16 for
// channels < cin of a live tap frame, else zeros.  Thread lt owns the
// 16-byte units lt, lt + 128, lt + 256, lt + 384 (rows lt/8 + 16i), all of
// channels ch .. ch + 7.
__device__ __forceinline__ void activate(uint4* half, const float* __restrict__ ab,
                                         const float* __restrict__ bb, int ch, bool on, int cin,
                                         int lt) {
  if (!on || ch >= cin) {
#pragma unroll
    for (int i = 0; i < 4; ++i) half[lt + 128 * i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  float av[8], bv[8];
  *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(ab + ch);
  *reinterpret_cast<float4*>(av + 4) = *reinterpret_cast<const float4*>(ab + ch + 4);
  *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(bb + ch);
  *reinterpret_cast<float4*>(bv + 4) = *reinterpret_cast<const float4*>(bb + ch + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4 raw = half[lt + 128 * i];
    uint32_t* u = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(u + e));
      const float z0 = fmaf(xv.x, av[2 * e], bv[2 * e]);
      const float z1 = fmaf(xv.y, av[2 * e + 1], bv[2 * e + 1]);
      u[e] = pack_bf16(silu_tanh(z0), silu_tanh(z1));
    }
    half[lt + 128 * i] = raw;
  }
}

// One accumulator's NB columns from n0 of the warpgroup's tile: y = acc +
// bias (+ residual, read from L2) in fp32, rounded to bf16 into the output
// tile `out` (shared), stored with one TMA store per chunk (rows past s are
// not written); then Σy, Σy² of the stored values over the sub-tile's
// `rows` rows, two columns a thread, written as the sub-tile's partials of
// the slab's fixed-order sums (their tickets are taken after the last
// tile).  The caller has made `out` free (the last store has read it).
template <int NB>
__device__ __forceinline__ void tap_epilogue(const TapParams& p, const float* acc, uint8_t* out,
                                             uint32_t out_s, int n0, const Half& me,
                                             const size_t* row_off, int r0, int lt) {
  using Chunks = typename TapLayout<NB>::Chunks;
  const int t = lt & 3;
#pragma unroll
  for (int jj = 0; jj < NB / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (n0 + col >= p.cout) continue;
    const float2 bv = *reinterpret_cast<const float2*>(p.bias + n0 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * jj + 2 * h] + bv.x, v1 = acc[4 * jj + 2 * h + 1] + bv.y;
      if (p.r != nullptr && me.s0 + r0 + 8 * h < p.s) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.r + row_off[h] + n0 + col));
        v0 += x.x;
        v1 += x.y;
      }
      *reinterpret_cast<uint32_t*>(out + out_offset<Chunks>(r0 + 8 * h, col)) =
          pack_bf16(v0, v1);
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + (threadIdx.x >= 128), 128);
  if (lt == 0) {
#pragma unroll
    for (int i = 0; i < Chunks::COUNT; ++i)
      if (n0 + Chunks::col(i) < p.cout)
        tma_store_4d(&p.out[Chunks::kind(i)], out_s + Chunks::offset(i, SUB),
                     n0 + Chunks::col(i), me.s0, me.fi, me.bi);
    bulk_commit();
  }
  const int rows = min(SUB, p.s - me.s0), col = 2 * lt;
  float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f;
  if (col < NB && n0 + col < p.cout) {
    for (int r = 0; r < rows; ++r) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(out + out_offset<Chunks>(r, col)));
      a0 += v.x;
      a1 += v.y;
      q0 = fmaf(v.x, v.x, q0);
      q1 = fmaf(v.y, v.y, q1);
    }
  }
  gemm::slab_sums_write(p.sums, p.cout, me.slab, me.s0 / SUB, n0 / NB, NB, lt, a0, a1, q0, q1);
}

template <int NB>
__global__ void __launch_bounds__(CONSUMERS, 1)
tap_conv_kernel(const __grid_constant__ TapParams p) {
  using L = TapLayout<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages;
  const uint32_t outs = base + stages * L::STAGE_BYTES;  // two output tiles
  const uint32_t full = outs + 2 * L::OUT_BYTES, empty = full + 8 * stages;
  const Ring ring{base, full, empty, static_cast<uint32_t>(L::STAGE_BYTES), stages};
  const int tid = threadIdx.x;

  if (tid == 0) {
    ring.init(CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 loads too: the first `stages` steps, then at each release the
  // step `stages` later into the released stage.
  TapCursor cur;
  if (tid == 0) {
    cur.start(p);
    for (int g = 0; g < stages && cur.valid(p); ++g, cur.advance(p))
      tap_load_step<NB>(p, ring, cur, g);
  }
  __syncwarp();
  auto release = [&](int g) {
    ring.release(g);
    if (tid == 0 && cur.valid(p)) {
      tap_load_step<NB>(p, ring, cur, g + stages);
      cur.advance(p);
    }
    __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
  };

  // ---- consumers: warpgroup wg owns sub-tile wg of each tile -------------
  const int wg = tid / 128, lt = tid % 128;
  const int r0 = (lt / 32) * 16 + (lt & 31) / 4;  // the thread's first row of the 64
  const int unit = (lt & 7) ^ ((lt >> 3) & 7);    // the 8-channel unit of its A chunks
  const uint32_t out = outs + wg * L::OUT_BYTES;
  uint8_t* out_ptr = smem_raw + (out - raw);
  float acc[NACC][NB / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Half h0 = half_of(p, tile, 0), h1 = half_of(p, tile, 1);
    const Half me = wg ? h1 : h0;
    const int n0 = (tile % p.col_tiles) * L::BN;
    if (p.r != nullptr && me.on && lt == 0)  // the residual tile into L2 for the epilogue
      for (int c0 = n0; c0 < n0 + L::BN && c0 < p.cout; c0 += 64)
        tma_prefetch_4d(&p.res, c0, me.s0, me.fi, me.bi);
    const float* ab = p.a + (size_t)me.bi * p.cin;
    const float* bb = p.sh + (size_t)me.bi * p.cin;
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int x = 0; x < NB / 2; ++x) acc[a][x] = 0.f;  // the last tile's values are dead
    bool first = true;
    for (int tap = 0; tap < 3; ++tap) {
      if (!tap_on(p, h0, tap) && !tap_on(p, h1, tap)) continue;  // skipped: no load, no product
      const bool on = tap_on(p, me, tap);
      for (int kb = 0; kb < p.nkc; ++kb, ++it) {
        const uint32_t st = ring.stage(it);
        ring.wait_full(it);
        activate(reinterpret_cast<uint4*>(smem_raw + (st - raw) + wg * HALF_BYTES), ab, bb,
                 kb * 64 + 8 * unit, on, p.cin, lt);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);  // the warpgroup's 64 rows are written
#pragma unroll
        for (int a = 0; a < NACC; ++a) fence_all<NB / 2>(acc[a]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < NACC; ++a)
            wgmma_ss<NB>(acc[a], desc_k_major(st + wg * HALF_BYTES + 32 * kk, 128),
                         desc_k_major(st + L::A_BYTES + a * NB * 128 + 32 * kk, 128),
                         !first || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step is done: release its stage
#pragma unroll
        for (int a = 0; a < NACC; ++a) fence_all<NB / 2>(acc[a]);
        if (!first) release(it - 1);
        first = false;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_all<NB / 2>(acc[a]);
    release(it - 1);

    if (me.on) {
      size_t row_off[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        row_off[h] = ((size_t)me.slab * p.s + me.s0 + r0 + 8 * h) * p.cout;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        if (lt == 0) bulk_wait_read();  // the last store has read the output tile
        named_bar_sync(1 + wg, 128);    // ... and the last sums too
        tap_epilogue<NB>(p, acc[a], out_ptr, out, n0 + a * NB, me, row_off, r0, lt);
      }
    }
  }
  // the tickets of this warp's sub-tiles, one a tile and accumulator
  const int tiles = blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  gemm::slab_sums_finish(p.sums, p.cout, NB, tiles * NACC, [&](int i) {
    const int tile = blockIdx.x + (i / NACC) * gridDim.x;
    const int chunk = (tile % p.col_tiles) * NACC + i % NACC;
    const Half me = half_of(p, tile, wg);
    return me.on && gemm::warp_sums(p.sums, p.cout, chunk, NB, lt >> 5)
               ? gemm::SumsSlot{me.slab, me.s0 / SUB, chunk}
               : gemm::SumsSlot{-1, 0, 0};
  }, lt);
  if (lt == 0) bulk_wait();
}

template <int NB>
int launch(TapParams& p, const void* x, const void* w, const void* y, const void* res, int bsz,
           int grid, int smem, cudaStream_t stream) {
  using L = TapLayout<NB>;
  if (p.stages < 2 || smem < L::smem(p.stages) || smem > gemm::SMEM_LIMIT || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t xdims[4] = {(uint64_t)p.cin, (uint64_t)p.s, (uint64_t)p.f, (uint64_t)bsz};
  const uint64_t ydims[4] = {(uint64_t)p.cout, (uint64_t)p.s, (uint64_t)p.f, (uint64_t)bsz};
  const uint32_t box[4] = {64, SUB, 1, 1};
  int err = make_map(&p.x, x, 4, xdims, box);
  if (!err) err = make_map_3d(&p.w, w, 3 * p.cin, p.cout, 1, 64, NB);
  for (int kind = 0; kind < 2 && !err; ++kind) {
    const uint32_t obox[4] = {64u >> kind, SUB, 1, 1};
    err = make_map(&p.out[kind], y, 4, ydims, obox);
  }
  if (!err && res != nullptr) err = make_map(&p.res, res, 4, ydims, box);
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(tap_conv_kernel<NB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tap_conv_kernel<NB><<<grid, CONSUMERS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// x: (bsz, f, s, cin) bf16; a, sh: (bsz, cin) fp32; w: (cout, 3, cin) bf16;
// bias: (cout,) fp32; res: (bsz, f, s, cout) bf16 or null; y: (bsz, f, s, cout)
// bf16; s1, s2: (bsz, f, cout) fp32, written; part: fp32 scratch and
// tickets: zeroed ints, left zeroed, as many as aat_slab_sums_sizes gives for
// (bsz·f, s, cout, 2·⌈cout/bn⌉) (part unused, may be null, at s <= 64).
// cin % 32 == 0, cout % 8 == 0, all 16-byte aligned.  The launch plan (ops/temporal_conv.py::launch_plan): tile width
// bn (320 = 2 x 160 or 256 = 2 x 128 output columns), ring stages,
// persistent grid and dynamic shared bytes.
AAT_EXPORT int aat_tap_conv(const void* x, const void* a, const void* sh, const void* w,
                            const void* bias, const void* res, void* y, void* s1, void* s2,
                            void* part, void* tickets, int bsz, int f, int s, int cin, int cout,
                            int bn, int stages, int grid, int smem, void* stream) {
  using namespace aat;
  if (bsz < 1 || f < 1 || s < 1 || cin % 32 != 0 || cin < 32 || cout % 8 != 0 || cout < 8 ||
      tickets == nullptr || (s > SUB && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TapParams p = {};
  p.r = static_cast<const bf16*>(res);
  p.a = static_cast<const float*>(a);
  p.sh = static_cast<const float*>(sh);
  p.bias = static_cast<const float*>(bias);
  p.f = f;
  p.s = s;
  p.cin = cin;
  p.cout = cout;
  p.subs_per_slab = (s + SUB - 1) / SUB;
  p.subs = bsz * f * p.subs_per_slab;
  p.col_tiles = (cout + bn - 1) / bn;
  p.tiles = (p.subs + 1) / 2 * p.col_tiles;
  p.nkc = (cin + 63) / 64;
  p.stages = stages;
  p.sums = gemm::SlabSums{static_cast<float*>(s1), static_cast<float*>(s2),
                          static_cast<float*>(part), static_cast<int*>(tickets), bsz * f,
                          p.subs_per_slab, p.col_tiles * NACC};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 320: return launch<160>(p, x, w, y, res, bsz, grid, smem, st);
    case 256: return launch<128>(p, x, w, y, res, bsz, grid, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
