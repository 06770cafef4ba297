// Kernel 9: attention over the frame axis of (b, f, s, h·d) projections, as a
// persistent kernel fed by a TMA ring.
//
// Replaces animate_anything_tpu/ops/temporal_attention.py::_packed_forward
// (_kernel).  For every (batch, location, head) the f × f problem is
//     o_i = Σ_g bf16(softmax_g(q_i·k_g / √d)) · v_g,
// fp32 scores and softmax, the normalised probabilities rounded to bf16 before
// the fp32 P·V, the output rounded to bf16.  The TPU kernel packs ⌊128/f⌋
// locations into one MXU tile under a same-location mask, after pack copies
// in HBM; both are facts of the 128-wide MXU and are not carried over.
//
// Bound on the H100: device memory.  q, k and v are read once and o written
// once; the math is 4·f·d flops a row against 8·d bytes (at f = 17, 8.5
// flops a byte, 35x below the card's bf16 ridge; 4.85 GFLOP at the largest
// site, 5 µs of tensor-core time against 170 µs of bytes).  So the design
// keeps bytes in flight all the time:
// - a persistent grid, one block a SM, walks tiles of (batch, L locations,
//   HB heads), heads fastest; a producer warp fills a ring of `stages`
//   tiles in shared memory by TMA under mbarriers, so while one tile
//   computes the next tiles' 3 x f x L x HB·d values are loading;
// - the tensor maps walk the (b, f, s, h·d) tensors as (h·d, f, s, b) (the
//   frame stride s·h·d), with boxes of 64 columns x f frames x L locations
//   (locations past s read as zeros), so one location's frames are adjacent
//   128-byte rows and the hardware's 128-byte swizzle spreads the 8 rows of
//   an ldmatrix over the banks; a head's columns start a chunk of their own
//   (at d % 64 != 0 a box also reads the next head's columns, unused);
// - a consumer warp takes one item at a time, the items of the block's
//   tiles dealt round robin: at f <= 32 a (location, head) with both its
//   16-row query tiles, which share the K and V fragments, else one query
//   tile.  S = Q·Kᵀ on mma.sync m16n8k16 (Q and K through ldmatrix, a k16
//   step of the head dim at a time), the fp32 softmax on the S registers in
//   base 2 (keys past f masked), P rounded to bf16 as the A operand of
//   O = P·V (V through ldmatrix.trans), one 64-column group of the head at a
//   time, so d up to 256 keeps 32 accumulators a query tile and reuses the
//   P fragments.  A query tile and the K and V tiles read rows past the
//   location's f (the next location's, or past the tile): their scores are
//   masked, their V rows zeroed in the fragment, their output rows never
//   stored;
// - each output group goes to the warp's staging buffer and leaves by TMA
//   store (64 columns, or 32/16/8-column pieces for the last group of a head
//   whose d is not a multiple of 64), so the store overlaps the next item's
//   math; the warp waits for the older store's reads before it writes the
//   buffer again.  Frames past f and locations past s are not written;
// - the warp releases its tile's stage after its item; the producer
//   refills the stage when every item of the tile has released it.
// The consumer warps' math, not the loads, set the pace of this layout's
// first version on the H100 (a run with the loads knocked out took as long
// as the whole kernel), so an item carries as few instructions as the
// layout allows.  mma.sync at the
// problem's own size, not wgmma: a 64-row wgmma tile would pack ⌊64/17⌋ = 3
// locations under a block-diagonal mask (the TPU's packing) with about 79 %
// of the scores masked, and the tensor-core rate does not bound this
// kernel.  No atomics: the output is the same bit for bit between calls.
// The launch plan (L, HB, stages, consumer warps, grid, shared memory) comes
// from ops/temporal_attention.py::launch_plan and is checked here.  Where
// two stages of one (location, head) do not fit (f > 88 with d > 128,
// f > 64 with d > 192), the plan takes one stage and a block's loads and
// math alternate.
#include "common.cuh"
#include "hopper.cuh"

namespace aat {
namespace {

using namespace hopper;

constexpr int MAX_WARPS = 8;        // consumer warps; one producer warp beside them
constexpr int STAGING = 32 * 128;   // a consumer warp's output staging: 32 rows x 64 bf16
constexpr int MAX_SMEM = 232448;

struct TaParams {
  CUtensorMap q, k, v;  // (h·d, f, s, b), box 64 x f x L x 1, 128-byte swizzle
  CUtensorMap o[4];     // (h·d, f, s, b), boxes {64, 32, 16, 8} x orows x 1 x 1
  int f, d, L, HB, hch;  // hch: 64-column chunks a head
  int items, tiles, lblocks, hblocks, stages, warps;
  float scale_log2;  // log2(e) / √d
};

// Shared memory: the ring of `stages` tiles (q, k, v, each HB·hch chunks of
// L·f rows of 128 bytes, rounded up to a 1024-byte swizzle atom), the
// consumer warps' staging, then a full and an empty mbarrier a stage; 1024
// bytes for the alignment.
__host__ __device__ constexpr int region_bytes(int L, int f) { return (L * f + 7) / 8 * 1024; }
__host__ __device__ constexpr int smem_bytes(int L, int f, int chunks, int stages, int warps) {
  return 1024 + stages * 3 * chunks * region_bytes(L, f) + warps * STAGING + 16 * stages;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A lane's ldmatrix row in a head's chunks: the row's address and its place
// in the 8-row swizzle atom; at() adds the 16-byte unit of head column col
// (a multiple of 8, chunk col / 64 of `region` bytes).
struct Row {
  uint32_t addr;
  int r7;
  Row() = default;
  __device__ __forceinline__ Row(uint32_t head_base, int r) : addr(head_base + r * 128), r7(r & 7) {}
  __device__ __forceinline__ uint32_t at(int col, int region) const {
    return addr + (col >> 6) * region + ((((col & 63) >> 3) ^ r7) << 4);
  }
};

// Byte offset of (row, col) of an output group narrower than 64 columns (cw)
// in a staging buffer of R rows: pieces of 32, 16 and 8 columns (64-byte,
// 32-byte swizzle, none) one after another.
template <int R>
__device__ __forceinline__ uint32_t out_at(int row, int col, int cw) {
  uint32_t base = 0;
  int c0 = 0;
#pragma unroll
  for (int w = 32; w >= 8; w >>= 1) {
    if (cw & w) {
      if (col < c0 + w) {
        const uint32_t o = row * 2 * w + (col - c0) * 2;
        const uint32_t atom = w == 32 ? 3 : w == 16 ? 1 : 0;
        return base + (o ^ (((o >> 7) & atom) << 4));
      }
      base += R * 2 * w;
      c0 += w;
    }
  }
  return base;
}

// NT: n8 key tiles, f ≤ 8·NT (4, 8 or 16); DP: the head dim rounded up to
// 64 (64, 128 or 256).  At f ≤ 32 an item is both 16-row query tiles of a
// (location, head), sharing their K and V fragments; above, one query tile.
template <int NT, int DP>
__global__ void __launch_bounds__((MAX_WARPS + 1) * 32, 1)
temporal_attention_kernel(const __grid_constant__ TaParams p) {
  constexpr int M = NT == 4 ? 2 : 1;  // query tiles an item
  constexpr int R = 16 * M;           // staging rows of a buffer
  constexpr int NBUF = 2 / M;         // staging buffers a warp
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int region = region_bytes(p.L, p.f);
  const int tensor = p.HB * p.hch * region;
  const int stage = 3 * tensor;
  const uint32_t staging = ring + p.stages * stage;
  const uint32_t full = staging + p.warps * STAGING;
  const uint32_t empty = full + 8 * p.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, p.items);  // one arrival an item
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == p.warps) {  // producer
    if (lane == 0) {
      for (int t = 0;; ++t) {
        const int tile = blockIdx.x + t * gridDim.x;
        if (tile >= p.tiles) break;
        const int stg = t % p.stages;
        mbar_wait(empty + 8 * stg, ((t / p.stages) & 1) ^ 1);
        // the boxes' bytes: L·f rows of each chunk (a region rounds them up)
        mbar_expect_tx(full + 8 * stg, 3 * p.HB * p.hch * p.L * p.f * 128);
        const int hk = tile % p.hblocks, rest = tile / p.hblocks;
        const int s0 = (rest % p.lblocks) * p.L, bi = rest / p.lblocks;
        uint32_t dst = ring + stg * stage;
        for (int hb = 0; hb < p.HB; ++hb)
          for (int j = 0; j < p.hch; ++j, dst += region) {
            const int col = (hk * p.HB + hb) * p.d + 64 * j;
            tma_load_4d(dst, &p.q, full + 8 * stg, col, 0, s0, bi);
            tma_load_4d(dst + tensor, &p.k, full + 8 * stg, col, 0, s0, bi);
            tma_load_4d(dst + 2 * tensor, &p.v, full + 8 * stg, col, 0, s0, bi);
          }
      }
    }
    return;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int d = p.d, f = p.f;
  const int mt = (f + 15) >> 4, per_unit = M == 2 ? 1 : mt;
  // ldmatrix row/column offsets of this lane: A (Q) and V.trans take rows
  // +8 from matrices 1 and 3, K rows +8 from matrices 2 and 3.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t out_buf = staging + warp * STAGING;
  int buf = 0;
  // The warp's items: every warps-th of the block's tiles' items in order
  // (warps ≤ items, so a warp meets every tile).
  int t = 0, it = warp, decoded = -1, s0 = 0, bi = 0, hk = 0;
  for (;; it += p.warps) {
    if (it >= p.items) {
      it -= p.items;
      ++t;
    }
    const int tile = blockIdx.x + t * gridDim.x;
    if (tile >= p.tiles) break;
    if (decoded != t) {
      hk = tile % p.hblocks;
      const int rest = tile / p.hblocks;
      s0 = (rest % p.lblocks) * p.L;
      bi = rest / p.lblocks;
      decoded = t;
    }
    const int mi = it % per_unit, u = it / per_unit;
    const int hb = u % p.HB, l = u / p.HB;
    const int head = hk * p.HB + hb;
    const int stg = t % p.stages;
    mbar_wait(full + 8 * stg, (t / p.stages) & 1);
    const uint32_t hq = ring + stg * stage + hb * p.hch * region;
    const uint32_t hkb = hq + tensor, hv = hkb + tensor;
    const int m0 = mi * M;  // this item's first query tile
    const int krow = l * f;  // the location's first row
    bool on[M];  // query tiles with rows < f
    Row qr[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      on[m] = m0 + m < mt;
      qr[m] = Row(hq, krow + 16 * (m0 + m) + a_row);
    }
    Row kr[NT / 2];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) kr[jp] = Row(hkb, krow + jp * 16 + b_row);

    // S = Q·Kᵀ over the key tiles that hold keys < f, a k16 step of the
    // head dim at a time.
    float sc[M][NT][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) sc[m][j][0] = sc[m][j][1] = sc[m][j][2] = sc[m][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 < d) {
        const bool half = kk * 16 + 8 >= d;  // the step's upper 8 columns are past d
        uint32_t qa[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if (on[m]) {
            ldsm_x4(qa[m], qr[m].at(kk * 16 + a_col, region));
            if (half) qa[m][2] = qa[m][3] = 0u;
          }
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (jp * 16 < f) {
            uint32_t kb[4];
            ldsm_x4(kb, kr[jp].at(kk * 16 + b_col, region));
            if (half) kb[1] = kb[3] = 0u;
#pragma unroll
            for (int m = 0; m < M; ++m) {
              if (on[m]) {
                mma_16816(sc[m][2 * jp], qa[m], kb);
                if (jp * 16 + 8 < f) mma_16816(sc[m][2 * jp + 1], qa[m], kb + 2);
              }
            }
          }
        }
      }
    }

    // Softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) of each query tile
    // over keys < f, in base 2 with the scale folded in; each row's values
    // sit in a quad.  P in bf16, two adjacent n8 tiles of S to a k16 step's
    // A operand.
    uint32_t pa[M][NT / 2][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < f) {  // key tiles past f stay out of the max and the sum
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * t4 + (e & 1);
            sc[m][j][e] = j * 8 + 8 <= f || col < f ? sc[m][j][e] * p.scale_log2 : -CUDART_INF_F;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[m][j][e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[m][j][e] = j * 8 < f ? ex2(sc[m][j][e] - mx[e >> 1]) : 0.f;  // 0 at the masked keys
          sum[e >> 1] += sc[m][j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        sum[r] = 1.f / sum[r];
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        pa[m][kk][0] = pack_bf16(sc[m][2 * kk][0] * sum[0], sc[m][2 * kk][1] * sum[0]);
        pa[m][kk][1] = pack_bf16(sc[m][2 * kk][2] * sum[1], sc[m][2 * kk][3] * sum[1]);
        pa[m][kk][2] = pack_bf16(sc[m][2 * kk + 1][0] * sum[0], sc[m][2 * kk + 1][1] * sum[0]);
        pa[m][kk][3] = pack_bf16(sc[m][2 * kk + 1][2] * sum[1], sc[m][2 * kk + 1][3] * sum[1]);
      }
    }

    // O = P·V a 64-column group at a time, each stored by TMA.
#pragma unroll
    for (int cg = 0; cg < DP / 64; ++cg) {
      if (cg * 64 < d) {
        const int cw = min(64, d - cg * 64);
        float acc[M][8][4];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int jd = 0; jd < 8; ++jd)
            acc[m][jd][0] = acc[m][jd][1] = acc[m][jd][2] = acc[m][jd][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          if (kk * 16 < f) {
            // V rows of keys past f hold the next location's values (or
            // whatever lies past the tile), so the step's keys past f are
            // zeroed: this lane's keys kk·16 + 8h + 2·t4 (+ 1).
            uint32_t keep[2] = {~0u, ~0u};
            if (kk * 16 + 16 > f) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int key = kk * 16 + 8 * h + 2 * t4;
                keep[h] = (key < f ? 0xffffu : 0u) | (key + 1 < f ? 0xffff0000u : 0u);
              }
            }
            const Row vr(hv, krow + kk * 16 + a_row);
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
              if (jp * 16 < cw) {
                uint32_t vb[4];
                ldsm_x4_t(vb, vr.at(cg * 64 + jp * 16 + a_col, region));
                vb[0] &= keep[0];
                vb[1] &= keep[1];
                vb[2] &= keep[0];
                vb[3] &= keep[1];
#pragma unroll
                for (int m = 0; m < M; ++m) {
                  if (on[m]) {
                    mma_16816(acc[m][2 * jp], pa[m][kk], vb);
                    if (jp * 16 + 8 < cw) mma_16816(acc[m][2 * jp + 1], pa[m][kk], vb + 2);
                  }
                }
              }
            }
          }
        }
        // The buffer's previous store must have read it.
        if (lane == 0) bulk_wait_read<NBUF - 1>();
        __syncwarp();
        const uint32_t ob = out_buf + buf * R * 128;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          if (cw == 64) {  // rows g and g + 8 share their place in the swizzle atom
            const uint32_t row = ob + (16 * m + g) * 128 + 4 * t4;
#pragma unroll
            for (int jd = 0; jd < 8; ++jd) {
              sts32(row + ((jd ^ g) << 4), pack_bf16(acc[m][jd][0], acc[m][jd][1]));
              sts32(row + 8 * 128 + ((jd ^ g) << 4), pack_bf16(acc[m][jd][2], acc[m][jd][3]));
            }
          } else {
#pragma unroll
            for (int jd = 0; jd < 8; ++jd) {
              const int col = jd * 8 + 2 * t4;
              if (col < cw) {
                sts32(ob + out_at<R>(16 * m + g, col, cw),
                      pack_bf16(acc[m][jd][0], acc[m][jd][1]));
                sts32(ob + out_at<R>(16 * m + g + 8, col, cw),
                      pack_bf16(acc[m][jd][2], acc[m][jd][3]));
              }
            }
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          const int oc = head * d + cg * 64, fr = 16 * m0, sl = s0 + l;
          if (cw == 64) {
            tma_store_4d(&p.o[0], ob, oc, fr, sl, bi);
          } else {
            uint32_t base = 0;
            int pc = 0;
            for (int w = 32, kind = 1; w >= 8; w >>= 1, ++kind) {
              if (cw & w) {
                tma_store_4d(&p.o[kind], ob + base, oc + pc, fr, sl, bi);
                base += R * 2 * w;
                pc += w;
              }
            }
          }
          bulk_commit();
        }
        buf = (buf + 1) % NBUF;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stg);
  }
  if (lane == 0) bulk_wait();
}

template <int NT, int DP>
int launch(const TaParams& p, int grid, int smem, cudaStream_t stream) {
  // Once per template instance: the largest dynamic shared memory any
  // launch may ask for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      temporal_attention_kernel<NT, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  temporal_attention_kernel<NT, DP><<<grid, (p.warps + 1) * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_d(const TaParams& p, int grid, int smem, cudaStream_t stream) {
  if (p.d <= 64) return launch<NT, 64>(p, grid, smem, stream);
  if (p.d <= 128) return launch<NT, 128>(p, grid, smem, stream);
  return launch<NT, 256>(p, grid, smem, stream);
}

}  // namespace
}  // namespace aat

// q, k, v, o: (b, f, s, heads·d) contiguous bf16.  2 <= f <= 128, d % 8 == 0,
// 8 <= d <= 256.  The plan (ops/temporal_attention.py::launch_plan): L
// locations x HB heads a tile (HB divides heads), `stages` tiles in the ring,
// `warps` consumer warps (at most the tile's items), `grid` blocks, `smem`
// bytes of dynamic shared memory (smem_bytes above).
AAT_EXPORT int aat_temporal_attention(const void* q, const void* k, const void* v, void* o, int b,
                                      int f, int s, int heads, int d, int L, int HB, int stages,
                                      int warps, int grid, int smem, void* stream) {
  using namespace aat;
  const int mt = (f + 15) / 16, hch = (d + 63) / 64;
  const int items = L * HB * (f <= 32 ? 1 : mt);
  if (f < 2 || f > 128 || d % 8 != 0 || d < 8 || d > 256 || b < 1 || s < 1 || L < 1 ||
      L > 256 || HB < 1 || heads % HB != 0 || stages < 1 || warps < 1 || warps > MAX_WARPS ||
      warps > items || grid < 1 || smem != smem_bytes(L, f, HB * hch, stages, warps) ||
      smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  TaParams p;
  p.f = f;
  p.d = d;
  p.L = L;
  p.HB = HB;
  p.hch = hch;
  p.items = items;
  p.lblocks = (s + L - 1) / L;
  p.hblocks = heads / HB;
  p.tiles = b * p.lblocks * p.hblocks;
  p.stages = stages;
  p.warps = warps;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  const uint64_t C = (uint64_t)heads * d;
  const uint64_t dims[4] = {C, (uint64_t)f, (uint64_t)s, (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)s * C * 2, C * 2, (uint64_t)f * s * C * 2};
  const uint32_t box[4] = {64, (uint32_t)f, (uint32_t)L, 1};
  int err = hopper::make_map_strided(&p.q, q, 4, dims, strides, box);
  if (!err) err = hopper::make_map_strided(&p.k, k, 4, dims, strides, box);
  if (!err) err = hopper::make_map_strided(&p.v, v, 4, dims, strides, box);
  // An item's output rows: both query tiles (f of them) at f <= 32, else 16.
  const uint32_t orows = f <= 32 ? f : 16;
  // Only the store widths this d uses: each encoding costs host time on
  // every call.
  for (int kind = 0; kind < 4 && !err; ++kind) {
    if (kind == 0 ? d < 64 : !(d % 64 & (64 >> kind))) continue;
    const uint32_t obox[4] = {64u >> kind, orows, 1, 1};
    err = hopper::make_map_strided(&p.o[kind], o, 4, dims, strides, obox);
  }
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  grid = min(grid, p.tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= 32) return launch_d<4>(p, grid, smem, st);
  if (f <= 64) return launch_d<8>(p, grid, smem, st);
  return launch_d<16>(p, grid, smem, st);
}
