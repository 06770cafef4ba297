// Kernel 11: LayerNorm rows -> q, k, v projections, the front half of
// animate_anything_tpu/ops/attic/ln_qkv_attention.py::_pallas_fwd (_kernel);
// kernel 1 (csrc/flash_attention.cu) is the back half.
//     ln = bf16(LN(x)),  q = bf16(ln·Wq · log2 e/√d),  k = bf16(ln·Wk),  v = bf16(ln·Wv)
// with the LayerNorm statistics in fp32 (two passes over the row) and fp32
// accumulation, q pre-scaled and rounded as the TPU kernel does before its
// exp2-domain softmax.
//
// The TPU kernel keeps the whole (s, c) sample and one head pair's K/V in
// VMEM and runs attention in the same program.  A Hopper block has 227 KB of
// shared memory, less than one 4096 × 320 sample, so the work is split at the
// one seam where the TPU kernel's intermediate is smallest: q, k and v go to
// device memory in the (b, s, h·d) layout that kernel 1 reads by stride (run
// with pre-scaled q), and the normalised rows never do.
//
// Bound on the H100: tensor-core math (6·c·h·d flops a row against 2·c +
// 6·h·d bytes).  Design, two launches:
// - the row statistics: gemm.cuh's LN pass under the ln_qkv owner tag, its
//   statistics alone (8 to 32 lanes a row by width, the row read once into
//   registers, fp32 mean and 1/σ by two passes over it, 8 bytes a row to
//   device memory, not the normalised row);
// - one persistent TMA + wgmma GEMM over [q ‖ k ‖ v]: a tile is 128 rows ×
//   BN columns of one of the three (BN divides h·d, so no tile straddles
//   two), tiles in row-major order with the column tile fastest, so the
//   blocks in flight share A rows in L2.  A producer thread keeps a ring of
//   64-deep K stages in flight: the raw x tile (128-byte swizzle, K-major)
//   and the weight tile read where it lies, (c, h·d) with h·d along the row,
//   as the MN-major B operand wgmma takes for 16-bit types (no transposed
//   copy of the weights).  Each consumer warpgroup owns 64 rows: per k16
//   step it reads its A fragment with ldmatrix, normalises it in registers
//   ((x − mean)·(1/σ)·scale + bias, fp32, one rounding to bf16, the
//   statistics of its two rows and the LayerNorm vectors of its four
//   columns) and issues BN/64 register-A wgmma m64n64k16 on the chunks of
//   the B tile, two fragments alternating so the next is built while the
//   last runs.  The epilogue scales the q columns by log2 e/√d, rounds to
//   bf16 and stores 64 columns at a time with TMA from two ping-pong
//   buffers a warpgroup.
// Rows past n read as zeros through the maps and are not stored; K past c
// reads as zeros in both operands (the LayerNorm vectors are zero-padded in
// shared memory, so the padded A columns are finite).
#include "gemm.cuh"

namespace aat {
namespace lnqkv {

using namespace hopper;

constexpr int THREADS = 256;  // two consumer warpgroups; thread 0 also issues the loads
constexpr int BM = 128, BK = 64;
constexpr int A_BYTES = BM * BK * 2;
constexpr int CHUNK_BYTES = BK * 128;  // one 64-column chunk of the B tile, 64 K rows
constexpr int OUT_BYTES = 64 * 128;    // one 64 x 64 output chunk
constexpr int SMEM_LIMIT = 232448;

// ---- the GEMM ------------------------------------------------------------------

struct Params {
  CUtensorMap a;       // x: (c cols, n rows), box 64 x 128
  CUtensorMap b[3];    // wq, wk, wv: (hd cols, c rows), box 64 x 64
  CUtensorMap out[3];  // q, k, v: (hd cols, n rows), box 64 x 64
  const float2* stats;
  const float* ln_s;
  const float* ln_b;
  int n, c, hd;
  int per_w;      // column tiles a weight (hd / BN)
  int col_tiles;  // 3 · per_w
  int tiles, stages;
  float qscale;
};

template <int BN>
struct Layout {
  static constexpr int CHUNKS = BN / 64;
  static constexpr int STAGE_BYTES = A_BYTES + CHUNKS * CHUNK_BYTES;
  // 1024 for the swizzle alignment; the ring and its two barriers a stage;
  // two ping-pong output chunks a warpgroup; the LayerNorm scale and bias
  // over c rounded up to BK.
  static constexpr int smem(int stages, int kpad) {
    return 1024 + stages * (STAGE_BYTES + 16) + 4 * OUT_BYTES + 2 * kpad * 4;
  }
};

// K step g of this block's tiles into its stage (thread 0), once the
// consumers released the stage's previous step.
template <int BN>
__device__ __forceinline__ void load_step(const Params& p, const Ring& ring, int nk, int g) {
  using L = Layout<BN>;
  const int tile = blockIdx.x + (g / nk) * gridDim.x, kb = g % nk;
  const int row_tile = tile / p.col_tiles, ct = tile % p.col_tiles;
  const int which = ct / p.per_w, col0 = (ct % p.per_w) * BN;
  const uint32_t st = ring.stage(g);
  const uint32_t bar = ring.acquire(g, L::STAGE_BYTES);
  tma_load_3d(st, &p.a, bar, kb * BK, row_tile * BM, 0);
#pragma unroll
  for (int i = 0; i < L::CHUNKS; ++i)
    tma_load_3d(st + A_BYTES + i * CHUNK_BYTES, &p.b[which], bar, col0 + 64 * i, kb * BK, 0);
}

__device__ __forceinline__ void ldmatrix_x4_u32(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Keeps a register-A fragment where it is until the wgmma reading it is done.
__device__ __forceinline__ void keep(uint32_t* f) {
  asm volatile("" : "+r"(f[0]), "+r"(f[1]), "+r"(f[2]), "+r"(f[3])::"memory");
}

// (x − mean)·(1/σ)·scale + bias of two bf16 of one row, packed back to bf16.
__device__ __forceinline__ uint32_t norm2(uint32_t raw, float mu, float rs, float2 s, float2 b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return pack_bf16((f.x - mu) * rs * s.x + b.x, (f.y - mu) * rs * s.y + b.y);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
ln_qkv_gemm_kernel(const __grid_constant__ Params p) {
  using L = Layout<BN>;
  using Chunk = HeadChunks<64>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages, nk = (p.c + BK - 1) / BK, kpad = nk * BK;
  const uint32_t outs = base + stages * L::STAGE_BYTES;  // 4 output chunks
  float* lns = reinterpret_cast<float*>(smem_raw + (outs + 4 * OUT_BYTES - raw));
  float* lnb = lns + kpad;
  const uint32_t full = smem_u32(lnb + kpad), empty = full + 8 * stages;
  const Ring ring{base, full, empty, static_cast<uint32_t>(L::STAGE_BYTES), stages};
  const int tid = threadIdx.x;

  for (int i = tid; i < kpad; i += THREADS) {  // zero past c
    lns[i] = i < p.c ? p.ln_s[i] : 0.f;
    lnb[i] = i < p.c ? p.ln_b[i] : 0.f;
  }
  if (tid == 0) {
    ring.init(THREADS);
    fence_barrier_init();
  }
  __syncthreads();

  const int steps = (blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * nk;
  if (tid == 0)
    for (int g = 0; g < steps && g < stages; ++g) load_step<BN>(p, ring, nk, g);
  __syncwarp();
  auto release = [&](int g) {  // thread 0 refills the stage
    ring.release(g);
    if (tid == 0 && g + stages < steps) load_step<BN>(p, ring, nk, g + stages);
    __syncwarp();  // warp 0 reconverges before the next .aligned wgmma
  };

  const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid & 31;
  const int g8 = lane / 4, t = lane & 3;
  const int r0 = warp * 16 + g8;  // the thread's first row of the warpgroup's 64
  // ldmatrix: lane l gives row (l & 15) of the warp's 16, 16-byte unit (l >> 4) of the k16 step
  const int lrow = wg * 64 + warp * 16 + (lane & 15);
  const uint32_t lrow_off = lrow * 128, lswz = lrow & 7;
  const uint32_t out_base = outs + wg * 2 * OUT_BYTES;
  uint8_t* out_ptr = smem_raw + (out_base - raw);
  float acc[BN / 2];
  uint32_t fa[2][BK / 16][4] = {};  // two stages' register-A fragments, alternating
  int it = 0, oc = 0;  // K steps and output chunks so far
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row_tile = tile / p.col_tiles, ct = tile % p.col_tiles;
    const int which = ct / p.per_w, col0 = (ct % p.per_w) * BN;
    const int row0 = row_tile * BM + wg * 64;  // the warpgroup's first row
    const int ra = row0 + r0, rb = ra + 8;
    const float2 sa = ra < p.n ? p.stats[ra] : make_float2(0.f, 0.f);
    const float2 sb = rb < p.n ? p.stats[rb] : make_float2(0.f, 0.f);
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) acc[x] = 0.f;
    fence_all<BN / 2>(acc);
    // K step kb from stage `it`: its four k16 fragments into f, the step
    // before (fragments g) done once this one is issued
    auto step = [&](int kb, uint32_t (&f)[BK / 16][4], uint32_t (&g)[BK / 16][4]) {
      const uint32_t st = ring.stage(it);
      ring.wait_full(it);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        ldmatrix_x4_u32(f[kk], st + lrow_off + (((2 * kk + (lane >> 4)) ^ lswz) << 4));
        const int col = kb * BK + 16 * kk + 2 * t;
        const float2 s0 = *reinterpret_cast<const float2*>(lns + col);
        const float2 b0 = *reinterpret_cast<const float2*>(lnb + col);
        const float2 s8 = *reinterpret_cast<const float2*>(lns + col + 8);
        const float2 b8 = *reinterpret_cast<const float2*>(lnb + col + 8);
        f[kk][0] = norm2(f[kk][0], sa.x, sa.y, s0, b0);
        f[kk][1] = norm2(f[kk][1], sb.x, sb.y, s0, b0);
        f[kk][2] = norm2(f[kk][2], sa.x, sa.y, s8, b8);
        f[kk][3] = norm2(f[kk][3], sb.x, sb.y, s8, b8);
      }
      fence_all<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < L::CHUNKS; ++i)
          wgmma_rs_tb<64>(acc + 32 * i, f[kk],
                          desc_mn_major(st + A_BYTES + i * CHUNK_BYTES + kk * 16 * 128, 128));
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one is done
      fence_all<BN / 2>(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) keep(g[kk]);
      if (kb > 0) release(it - 1);
      ++it;
    };
    for (int kb = 0; kb < nk; kb += 2) {  // the two fragment sets alternate
      step(kb, fa[0], fa[1]);
      if (kb + 1 < nk) step(kb + 1, fa[1], fa[0]);
    }
    wgmma_wait<0>();
    fence_all<BN / 2>(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      keep(fa[0][kk]);
      keep(fa[1][kk]);
    }
    release(it - 1);

    // ---- epilogue: 64 columns at a time through two ping-pong chunks ------
    const float scale = which == 0 ? p.qscale : 1.f;
#pragma unroll
    for (int i = 0; i < L::CHUNKS; ++i) {
      const uint32_t ob = out_base + (oc & 1) * OUT_BYTES;
      uint8_t* op = out_ptr + (oc++ & 1) * OUT_BYTES;
      if (lt == 0) bulk_wait_read<1>();  // the store before last, from this buffer, has read it
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* v = acc + 32 * i + 4 * jj + 2 * h;
          *reinterpret_cast<uint32_t*>(op + out_offset<Chunk>(r0 + 8 * h, 8 * jj + 2 * t)) =
              pack_bf16(v[0] * scale, v[1] * scale);
        }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (lt == 0 && row0 < p.n) {
        tma_store_3d(&p.out[which], ob, col0 + 64 * i, row0, 0);
        bulk_commit();
      }
    }
  }
  if (lt == 0) bulk_wait();
}

template <int BN>
int launch_gemm(Params& p, const void* x, const void* const* w, void* const* out, int grid,
                int smem, cudaStream_t stream) {
  using L = Layout<BN>;
  const int kpad = (p.c + BK - 1) / BK * BK;
  if (p.stages < 2 || smem < L::smem(p.stages, kpad) || smem > SMEM_LIMIT || grid < 1 ||
      p.hd % BN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = make_map_3d(&p.a, x, p.c, p.n, 1, BK, BM);
  for (int i = 0; i < 3 && !err; ++i) {
    err = make_map_3d(&p.b[i], w[i], p.hd, p.c, 1, 64, BK);
    if (!err) err = make_map_3d(&p.out[i], out[i], p.hd, p.n, 1, 64, 64);
  }
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_gemm_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_qkv_gemm_kernel<BN><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lnqkv
}  // namespace aat

// x: (n, c) bf16; ln_s, ln_b: (c,) fp32; wq, wk, wv: (c, hd) bf16, as JAX
// keeps them (hd along the row); q, k, v: (n, hd) bf16; stats: n·2 fp32
// scratch.  c % 8 == 0, hd % bn == 0.  qscale: the factor applied to q before
// its rounding (log2 e/√d).  The launch plan
// (ops/ln_qkv_attention.py::launch_plan): the tile width bn (64, 128, 192,
// 256 or 320), ring stages, persistent grid and dynamic shared bytes.
AAT_EXPORT int aat_ln_qkv(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                          const void* wk, const void* wv, void* q, void* k, void* v, void* stats,
                          int n, int c, int hd, float eps, float qscale, int bn, int stages,
                          int grid, int smem, void* stream) {
  using namespace aat::lnqkv;
  if (n < 1 || c < 8 || c % 8 != 0 || c > 4096 || hd < 64 || hd % 64 != 0 || bn < 64 ||
      hd % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // gemm.cuh's LN pass, its statistics alone
  int err = aat::gemm::launch_layer_norm<aat::ln_qkv, true>(x, ln_s, ln_b, stats, n, c, c, eps,
                                                           st);
  if (err) return err;
  Params p = {};
  p.stats = static_cast<const float2*>(stats);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.n = n;
  p.c = c;
  p.hd = hd;
  p.per_w = hd / bn;
  p.col_tiles = 3 * p.per_w;
  p.tiles = (n + BM - 1) / BM * p.col_tiles;
  p.stages = stages;
  p.qscale = qscale;
  const void* w[3] = {wq, wk, wv};
  void* out[3] = {q, k, v};
  switch (bn) {
    case 320: return launch_gemm<320>(p, x, w, out, grid, smem, st);
    case 256: return launch_gemm<256>(p, x, w, out, grid, smem, st);
    case 192: return launch_gemm<192>(p, x, w, out, grid, smem, st);
    case 128: return launch_gemm<128>(p, x, w, out, grid, smem, st);
    case 64: return launch_gemm<64>(p, x, w, out, grid, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
