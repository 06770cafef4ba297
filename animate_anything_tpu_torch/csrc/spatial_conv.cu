// Kernel 8: one resnet stage, GroupNorm-affine (+SiLU) -> 3x3 conv with zero
// padding + per-sample bias (+ residual), on TMA and wgmma.
//
// Replaces animate_anything_tpu/ops/attic/spatial_conv.py::_pallas_stage
// (_kernel) and animate_anything_tpu/ops/attic/conv3x3.py::_pallas_stage
// (_kernel), the same function without the residual.  Per output pixel
// (i, h, w) of an (n, H, W, cin) input:
//     y = Σ_{dy,dx} act(x[i, h+dy-1, w+dx-1])·W[dy, dx] + bias[i] (+ residual)
//     act(x) = SiLU(a_i·x + b_i) in fp32 rounded to bf16, zero outside the image
// with the GroupNorm statistics already folded into the per-(sample,
// channel) (a, b) by group_affine, and bias[i] the conv bias plus the
// resnet's time-embedding projection.
//
// Bound on the H100: tensor-core math (18·cin·cout flops per pixel against
// (cin + cout)·2 bytes).  Design: two launches, an activation pass and a
// pure implicit GEMM on the skeleton of kernel 3 (csrc/temporal_conv.cu),
// generalised from 3 frame taps to 9 spatial taps:
// - the activation pass writes act = SiLU(a·x + b) in fp32, rounded once to
//   bf16, into an (n, H, W, cin) buffer: 16 bytes a thread, one ex2 and one
//   reciprocal an element (gemm.cuh's silu_tanh).  This splits the TPU
//   kernel's fusion: act goes through device memory (4·n·H·W·cin bytes
//   written and read back, ~1.3 ms a CFG forward at 3.35 TB/s against the
//   forward's ~11 ms FLOP bound), where the first version activated the
//   halo on chip once for every 128-column tile (about 6 times an element at
//   c = 320, 14 at c = 1280);
// - the GEMM has M = n·H·W pixels, N = cout, K = 9·cin over the conv
//   weight in channels_last, whose memory is (cout, 9·cin), K-major, column
//   (3·dy + dx)·cin + ci (ops/spatial_conv.py::pack_weight).  A 128-pixel
//   tile is two 64-pixel sub-tiles, one a consumer warpgroup; a sub-tile is
//   TR whole image rows of TW = W rounded up to a power of two (TR = 64 /
//   TW) where W <= 64, so at 8 x 8 it is a whole image and a tile two
//   images, none half-empty; past W = 64 it is a 64-pixel run of one row.
//   Each sub-tile's A box of a K step is one TMA box of 64 channels x TW x
//   TR x 1 over a 4-D map (cin, W, H, n) at (c0, w0 + dx − 1, h0 + dy − 1,
//   image): TMA zero-fills the pixels outside the image and the channels
//   past cin, and because act is already activated those zeros are exactly
//   the conv's zero padding after the activation.  The box lands as 64
//   rows of 128 bytes in the 128-byte swizzle, the layout of a K-major
//   wgmma operand, so the mainloop is TMA and wgmma alone.  The nine tap
//   reads of A hit L2;
// - a ring of 64-channel K stages (tap-major) on full mbarriers, persistent
//   blocks with the column tile fastest, BN = NB x NACC output columns a
//   tile: 256 = 2 x 128 with one block a SM (cout > 640), or 160 = 1 x 160
//   with two blocks a SM (80 accumulator registers, at most 128 a thread,
//   3 stages in half the shared memory), the launch plan's: the two blocks
//   hide each other's load waits at the 64² and 32² sites (c <= 640).  B
//   rows past cout read as zeros and are not stored.  A producer warp would make the block nine
//   warps, which leaves a thread 168 registers for the 128 accumulator
//   registers at BN = 256, so the loads come from the consumers: once a
//   warpgroup's products of a step are done, its first thread counts it in
//   the stage's counter, and the second warpgroup to finish refills the
//   stage with the step `stages` later.  No thread waits for the other warpgroup: the first
//   version's thread 0 blocked on an empty barrier until both had released
//   the stage, and its warpgroup with it (5-9 % slower at every UNet site).
//   Knock-outs (PERF.md §6): the loads and their per-step round trip,
//   not the tensor cores, bound the mainloop; B multicast over a 2-CTA
//   cluster, an L2 prefetch of the next tile's rows, 4 stages against 3 and
//   a third of the A bytes each moved it by under 3 %;
// - the epilogue straight from the accumulators: y = acc + bias[i] (+ the
//   residual, prefetched into L2 by TMA at the tile's start) in fp32,
//   rounded once to bf16 and stored two columns a thread, skipping the
//   pixels past W and H.  No output tile in shared memory leaves room for a
//   fourth 48 KB stage at BN = 256;
// The TPU kernel's cin split and cout chunking were VMEM limits and have no
// counterpart here.  Tiles, ring depth, grid and shared-memory bytes come
// from the wrapper's launch plan (ops/spatial_conv.py::launch_plan),
// checked here.  Kernel names carry "spatial_conv", so a profile
// attributes both launches to kernel 8.
#include "gemm.cuh"

namespace aat {
namespace {

using namespace hopper;
using gemm::CONSUMERS;
using gemm::silu_tanh;

constexpr int SUB = 64;                // pixels of a sub-tile (one warpgroup's)
constexpr int HALF_BYTES = SUB * 128;  // its A box of a 64-channel K step
constexpr int ACT_THREADS = 256;
constexpr int ACT_BLOCKS = 132 * 8;    // the activation pass's grid-stride blocks, at most

// ---- the activation pass ---------------------------------------------------

// act = SiLU(a·x + b) (or a·x + b) over (n, H, W, cin), eight channels a
// thread-iteration; `img_units` = H·W·cin / 8.
__global__ void __launch_bounds__(ACT_THREADS)
spatial_conv_act_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ sh, bf16* __restrict__ act, long long units,
                        long long img_units, int cin, int silu) {
  const int cu = cin / 8;
  for (long long u = (long long)blockIdx.x * ACT_THREADS + threadIdx.x; u < units;
       u += (long long)gridDim.x * ACT_THREADS) {
    const size_t ab = (size_t)(u / img_units) * cin + (size_t)(u % cu) * 8;
    float av[8], bv[8];
    *reinterpret_cast<float4*>(av) = __ldg(reinterpret_cast<const float4*>(a + ab));
    *reinterpret_cast<float4*>(av + 4) = __ldg(reinterpret_cast<const float4*>(a + ab + 4));
    *reinterpret_cast<float4*>(bv) = __ldg(reinterpret_cast<const float4*>(sh + ab));
    *reinterpret_cast<float4*>(bv + 4) = __ldg(reinterpret_cast<const float4*>(sh + ab + 4));
    uint4 raw = reinterpret_cast<const uint4*>(x)[u];
    uint32_t* e = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e + i));
      float z0 = fmaf(xv.x, av[2 * i], bv[2 * i]), z1 = fmaf(xv.y, av[2 * i + 1], bv[2 * i + 1]);
      if (silu) {
        z0 = silu_tanh(z0);
        z1 = silu_tanh(z1);
      }
      e[i] = pack_bf16(z0, z1);
    }
    reinterpret_cast<uint4*>(act)[u] = raw;
  }
}

// ---- the implicit GEMM -----------------------------------------------------

// A tile of BN = NB·NACC output columns: the ring of 64-channel K stages (A:
// two 64-pixel sub-tiles, B: BN weight rows), then a full barrier and a
// done-counter (8 bytes each) a stage.
template <int NB, int NACC>
struct ConvLayout {
  static constexpr int BN = NB * NACC;
  static constexpr int A_BYTES = 2 * HALF_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + BN * 128;
  static constexpr int smem(int stages) { return 1024 + stages * (STAGE_BYTES + 16); }
};

struct ConvParams {
  CUtensorMap act;     // 4-D (cin, W, H, n) bf16, box 64 x TW x TR x 1
  CUtensorMap w;       // (9·cin cols, cout rows) bf16, box 64 x NB
  CUtensorMap res;     // 4-D (cout, W, H, n) bf16, box 64 x TW x TR x 1 (L2 prefetch only)
  const bf16* r;       // the residual (n, H, W, cout) or null
  const float* bias;   // (n, cout) fp32
  bf16* y;             // (n, H, W, cout)
  int H, W, cin, cout;
  int tw_log2, tr, tiles_w, subs_per_img, subs;  // sub-tiles: TW x TR pixels of one image
  int col_tiles, tiles, nkc, ksteps, stages;     // K steps: 9 taps x nkc 64-channel steps
};

// One warpgroup's sub-tile of a block tile: its image and first pixel.
struct Sub {
  bool on;  // the sub-tile exists (the last tile of an odd count has one)
  int img, h0, w0;
};

__device__ __forceinline__ Sub sub_of(const ConvParams& p, int tile, int h) {
  const int sub = 2 * (tile / p.col_tiles) + h;
  Sub r;
  r.on = sub < p.subs;
  const int s = r.on ? sub : 0;
  r.img = s / p.subs_per_img;
  const int t = s % p.subs_per_img;
  r.h0 = (t / p.tiles_w) * p.tr;
  r.w0 = (t % p.tiles_w) << p.tw_log2;
  return r;
}

// K step g of this block's tiles (tile blockIdx.x + (g / ksteps)·gridDim.x;
// tap k / nkc, channels from 64·(k % nkc)) into its stage, once both
// warpgroups are done with the stage: each sub-tile's shifted A box and the
// B boxes (one thread).
template <int NB, int NACC>
__device__ __forceinline__ void conv_load_step(const ConvParams& p, const Ring& ring, int g) {
  using L = ConvLayout<NB, NACC>;
  const int tile = blockIdx.x + (g / p.ksteps) * gridDim.x, k = g % p.ksteps;
  const int tap = k / p.nkc, c0 = (k % p.nkc) * 64;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const Sub s0 = sub_of(p, tile, 0), s1 = sub_of(p, tile, 1);
  const uint32_t st = ring.stage(g), bar = ring.full_bar(g);
  mbar_expect_tx(bar, (s0.on + s1.on) * HALF_BYTES + L::BN * 128);
  if (s0.on) tma_load_4d(st, &p.act, bar, c0, s0.w0 + dx, s0.h0 + dy, s0.img);
  if (s1.on) tma_load_4d(st + HALF_BYTES, &p.act, bar, c0, s1.w0 + dx, s1.h0 + dy, s1.img);
#pragma unroll
  for (int a = 0; a < NACC; ++a)
    tma_load_3d(st + L::A_BYTES + a * NB * 128, &p.w, bar, tap * p.cin + c0,
                (tile % p.col_tiles) * L::BN + a * NB, 0);
}

// One accumulator's NB columns from n0 of the warpgroup's tile: y = acc +
// bias (+ residual, read from L2) in fp32, rounded to bf16 and stored two
// columns a thread; rows of pixels past W and H are not written.
template <int NB>
__device__ __forceinline__ void conv_epilogue(const ConvParams& p, const float* acc, int n0,
                                              const Sub& me, const size_t* row_off,
                                              const bool* row_ok, int lt) {
  const int t = lt & 3;
  const float* bias = p.bias + (size_t)me.img * p.cout;
#pragma unroll
  for (int jj = 0; jj < NB / 8; ++jj) {
    const int col = n0 + 8 * jj + 2 * t;
    if (col >= p.cout) continue;
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_ok[h]) continue;
      float v0 = acc[4 * jj + 2 * h] + bv.x, v1 = acc[4 * jj + 2 * h + 1] + bv.y;
      if (p.r != nullptr) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.r + row_off[h] + col));
        v0 += x.x;
        v1 += x.y;
      }
      *reinterpret_cast<uint32_t*>(p.y + row_off[h] + col) = pack_bf16(v0, v1);
    }
  }
}

template <int NB, int NACC>
__global__ void __launch_bounds__(CONSUMERS, NACC == 1 ? 2 : 1)  // blocks a SM: see the header
spatial_conv_gemm_kernel(const __grid_constant__ ConvParams p) {
  using L = ConvLayout<NB, NACC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages;
  const uint32_t full = base + stages * L::STAGE_BYTES;
  // the ring's stages and full barriers (no empty barriers: `done` counts
  // the warpgroups that finished a stage's step)
  const Ring ring{base, full, 0, static_cast<uint32_t>(L::STAGE_BYTES), stages};
  int* done = reinterpret_cast<int*>(smem_raw + (full + 8 * stages - raw));
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      done[s] = 0;
    }
    fence_barrier_init();
  }
  __syncthreads();

  // this block's K steps over all its tiles; thread 0 loads the first
  // `stages`, then the second warpgroup done with a step refills its stage
  const int steps =
      (blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * p.ksteps;
  if (tid == 0)
    for (int g = 0; g < steps && g < stages; ++g) conv_load_step<NB, NACC>(p, ring, g);
  __syncwarp();
  auto release = [&](int g) {
    named_bar_sync(1 + (tid >> 7), 128);  // the warpgroup's products of step g are done
    if ((tid & 127) == 0 && atomicAdd(done + g % stages, 1) == 1) {
      done[g % stages] = 0;  // the other warpgroup counted first: the stage is free
      if (g + stages < steps) conv_load_step<NB, NACC>(p, ring, g + stages);
    }
    __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
  };

  // ---- consumers: warpgroup wg owns sub-tile wg of each tile -------------
  const int wg = tid / 128, lt = tid % 128;
  const int r0 = (lt / 32) * 16 + (lt & 31) / 4;  // the thread's first row of the 64
  const int tw_mask = (1 << p.tw_log2) - 1;
  float acc[NACC][NB / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Sub me = sub_of(p, tile, wg);
    const int n0 = (tile % p.col_tiles) * L::BN;
    if (p.r != nullptr && me.on && lt == 0)  // the residual tile into L2 for the epilogue
      for (int c0 = n0; c0 < n0 + L::BN && c0 < p.cout; c0 += 64)
        tma_prefetch_4d(&p.res, c0, me.w0, me.h0, me.img);
    for (int k = 0; k < p.ksteps; ++k, ++it) {
      const uint32_t st = ring.stage(it);
      ring.wait_full(it);
#pragma unroll
      for (int a = 0; a < NACC; ++a) fence_all<NB / 2>(acc[a]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < NACC; ++a)
          wgmma_ss<NB>(acc[a], desc_k_major(st + wg * HALF_BYTES + 32 * kk, 128),
                       desc_k_major(st + L::A_BYTES + a * NB * 128 + 32 * kk, 128),
                       k > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step is done: release its stage
#pragma unroll
      for (int a = 0; a < NACC; ++a) fence_all<NB / 2>(acc[a]);
      if (k > 0) release(it - 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_all<NB / 2>(acc[a]);
    release(it - 1);

    if (me.on) {
      // the thread's two rows: pixel (h0 + r / TW, w0 + r % TW) of the image
      size_t row_off[2];
      bool row_ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int hh = me.h0 + (r >> p.tw_log2), ww = me.w0 + (r & tw_mask);
        row_ok[h] = hh < p.H && ww < p.W;
        row_off[h] = (((size_t)me.img * p.H + hh) * p.W + ww) * p.cout;
      }
#pragma unroll
      for (int a = 0; a < NACC; ++a)
        conv_epilogue<NB>(p, acc[a], n0 + a * NB, me, row_off, row_ok, lt);
    }
  }
}

template <int NB, int NACC>
int launch(ConvParams& p, const void* act, const void* w, void* y, const void* res, int n,
           int grid, int smem, cudaStream_t stream) {
  using L = ConvLayout<NB, NACC>;
  if (p.stages < 2 || smem < L::smem(p.stages) || smem > gemm::SMEM_LIMIT || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t adims[4] = {(uint64_t)p.cin, (uint64_t)p.W, (uint64_t)p.H, (uint64_t)n};
  const uint64_t ydims[4] = {(uint64_t)p.cout, (uint64_t)p.W, (uint64_t)p.H, (uint64_t)n};
  const uint32_t box[4] = {64, 1u << p.tw_log2, static_cast<uint32_t>(p.tr), 1};
  int err = make_map(&p.act, act, 4, adims, box);
  if (!err) err = make_map_3d(&p.w, w, 9 * (uint64_t)p.cin, p.cout, 1, 64, NB);
  if (!err && res != nullptr) err = make_map(&p.res, res, 4, ydims, box);
  p.y = static_cast<bf16*>(y);
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(spatial_conv_gemm_kernel<NB, NACC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  spatial_conv_gemm_kernel<NB, NACC><<<grid, CONSUMERS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// x: (n, H, W, cin) bf16; a, sh: (n, cin) fp32; w: (cout, 9·cin) bf16, the
// channels_last conv weight (column (3·dy + dx)·cin + ci); bias: (n, cout) fp32; res:
// (n, H, W, cout) bf16 or null; act: (n, H, W, cin) bf16 scratch; y: (n, H,
// W, cout) bf16.  cin % 16 == 0, cout % 8 == 0, all 16-byte aligned.  The
// launch plan (ops/spatial_conv.py::launch_plan): tile width bn (256 = 2 x
// 128 output columns, one block a SM, or 160 = 1 x 160, two), ring stages,
// persistent grid and dynamic shared bytes.
AAT_EXPORT int aat_spatial_conv(const void* x, const void* a, const void* sh, const void* w,
                                const void* bias, const void* res, void* act, void* y, int n,
                                int H, int W, int cin, int cout, int silu, int bn, int stages,
                                int grid, int smem, void* stream) {
  using namespace aat;
  if (n < 1 || H < 1 || W < 1 || cin % 16 != 0 || cin < 16 || cout % 8 != 0 || cout < 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long img_units = (long long)H * W * cin / 8, units = img_units * n;
  const int blocks = static_cast<int>(
      units / ACT_THREADS + 1 < ACT_BLOCKS ? units / ACT_THREADS + 1 : ACT_BLOCKS);
  spatial_conv_act_kernel<<<blocks, ACT_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(sh),
      static_cast<bf16*>(act), units, img_units, cin, silu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  ConvParams p = {};
  p.r = static_cast<const bf16*>(res);
  p.bias = static_cast<const float*>(bias);
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.tw_log2 = 0;  // TW: the power of two >= W, at most 64
  while ((1 << p.tw_log2) < W && p.tw_log2 < 6) ++p.tw_log2;
  p.tr = SUB >> p.tw_log2;
  p.tiles_w = (W + (1 << p.tw_log2) - 1) >> p.tw_log2;
  p.subs_per_img = (H + p.tr - 1) / p.tr * p.tiles_w;
  p.subs = n * p.subs_per_img;
  p.col_tiles = (cout + bn - 1) / bn;
  p.tiles = (p.subs + 1) / 2 * p.col_tiles;
  p.nkc = (cin + 63) / 64;
  p.ksteps = 9 * p.nkc;
  p.stages = stages;
  switch (bn) {
    case 256: return launch<128, 2>(p, act, w, y, res, n, grid, smem, st);
    case 160: return launch<160, 1>(p, act, w, y, res, n, grid, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
