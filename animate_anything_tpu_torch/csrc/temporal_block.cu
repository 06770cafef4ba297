// Kernel 5: the fused temporal-attention block, one pass per block of
// spatial locations.
//
// Replaces animate_anything_tpu/ops/temporal_block.py::_build_bfsc
// (_kernel_bfsc) and ::_build (_kernel, with the head-group split of
// _build_vjp) with one kernel on the natural (b, f, s, c) layout:
//     y = x + bo + Wo·attn(LN(x)),   q|k|v = LN(x)·Wq|k|vᵀ,
// attention over the f frames of each (batch, location, head).  LN
// statistics, scores and softmax are fp32; LN(x), q, k, v, the probabilities
// and the attention output are rounded to bf16 before their next product,
// as in the JAX reference (_reference_bfsc).
//
// Bound on the H100: tensor-core math in the four c x c projections
// (8·c² flops per row) against weights re-read from L2 by every block;
// the frame attention itself is ~4·f·c flops per row (f = 17).  Design: a block owns L consecutive locations of one
// batch, i.e. L·f rows, padded to M = 16·⌈L·f/16⌉ (at most 128).  A
// location's f frames are f strided chunks of L·c contiguous elements, so
// the block reads x with 16-byte copies and no pack pass.  Shared memory
// holds the block's LN'd rows and its attention output (bf16, M x c each)
// for the whole kernel, one head's q, k, v (bf16, M x d each), and two
// cp.async stages of 192 weight rows x 32 columns; L is the largest count
// whose rows fit (L = 6 / 4 / 3 at c = 320 / 512 / 640, f = 17).  At
// c > 1024 both buffers would leave room for one location (17 of 32 rows
// used), so the block keeps only the LN'd rows (L = 3 at c = 1280), writes
// the attention output to device memory, and a second launch runs the
// out-projection.
// Per head, one mma.sync product of the LN'd rows against the head's 3·d
// rows of Wq, Wk, Wv gives q, k, v (stored location-major, so that the f
// rows of a location are consecutive ldmatrix rows); one warp per location
// then computes S = q·kᵀ on the tensor cores (f x f padded to 16·⌈f/16⌉ x
// 8·⌈f/8⌉), the fp32 softmax on the S fragments, and O = P·v with P fed
// from registers.  The out-projection streams Wo in 192-column chunks; its
// epilogue adds bo and x in fp32 and stores bf16.
//
// The ragged edge: locations past s are zero-filled on load (cp.async with
// src-size 0), their LN rows stay zero (finite q, k, v), a real query only
// ever reads the key and value rows of its own location, and stores past s
// are skipped.  (The TPU kernel's edge block instead reads garbage past the
// array, and its P·V multiplies that garbage by zero probabilities, which
// leaks NaN into real rows.)
//
// Block: 8 warps; grid (⌈s / L⌉, b).
#include "common.cuh"

namespace aat {
namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_MT = 8;                // row fragments of 16: at most 128 rows
constexpr int NT = 3;                    // column fragments of 8 per warp
constexpr int NCH = WARPS * NT * 8;      // 192 weight rows (output columns) per chunk
constexpr int KC = 32;                   // k per weight stage
constexpr int STAGES = 2;                // weight stages in flight
constexpr int WLD = KC + 8;              // weight stage row stride (bf16)
constexpr int MAX_F = 32;                // two 16-row query tiles per location
constexpr int MAX_D = 64;                // q|k|v of one head fit one 192-row chunk
constexpr size_t SMEM_LIMIT = 232448;

inline int rup16(int v) { return (v + 15) / 16 * 16; }

// v rows: the block's rows, and the rows its last location's frame attention
// reads past them (16·⌈f/16⌉ from the location's first).  q and k have M rows
// each: their reads past the block's rows fall into the next buffer (k, v),
// whose rows are finite, and only feed dropped query rows and masked keys.
__host__ __device__ inline int v_rows(int L, int f) {
  const int tail = (L - 1) * f + (f + 15) / 16 * 16;
  const int M = (L * f + 15) / 16 * 16;
  return tail > M ? tail : M;
}

size_t smem_bytes(int L, int f, int c, int d, bool fuse_out) {
  const int M = rup16(L * f);
  return (size_t)(fuse_out ? 2 : 1) * M * (c + 8) * sizeof(bf16)  // LN'd rows, attention output
         + (size_t)STAGES * NCH * WLD * sizeof(bf16)               // weight stages
         + (size_t)(2 * M + v_rows(L, f)) * (d + 8) * sizeof(bf16); // one head's q, k, v
}

// Locations per block: the most whose rows fit shared memory.
int pick_locations(int f, int s, int c, int d, bool fuse_out) {
  for (int L = (MAX_MT * 16) / f < s ? (MAX_MT * 16) / f : s; L >= 1; --L)
    if (smem_bytes(L, f, c, d, fuse_out) <= SMEM_LIMIT) return L;
  return 0;
}

// The 192 weight rows of one chunk: row n is seg[n / seg_rows] +
// (n % seg_rows)·K; rows n >= nvalid are zero-filled and their fragments
// skipped.
struct WeightRows {
  const bf16* seg[3];
  int seg_rows;
  int nvalid;
};

// Each thread's cp.async slots of a weight stage: the same rows and columns
// at every k, so the row pointers are worked out once per product.
constexpr int W_LOADS = NCH * (KC / 8) / THREADS;
static_assert(NCH * (KC / 8) % THREADS == 0, "whole weight stages per thread");

struct WeightLoads {
  const bf16* src[W_LOADS];
  int dst[W_LOADS];
  int bytes[W_LOADS];

  __device__ __forceinline__ WeightLoads(const WeightRows& w, int K) {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int idx = threadIdx.x + i * THREADS, n = idx / (KC / 8), v = idx % (KC / 8);
      const bool ok = n < w.nvalid;
      src[i] = ok ? w.seg[n / w.seg_rows] + (size_t)(n % w.seg_rows) * K + v * 8 : w.seg[0];
      dst[i] = n * WLD + v * 8;
      bytes[i] = ok ? 16 : 0;
    }
  }

  __device__ __forceinline__ void stage(bf16* wst, int k0) const {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) cp_async16(wst + dst[i], src[i] + (bytes[i] ? k0 : 0), bytes[i]);
  }
};

// acc = A·Bᵀ for the block's MT row fragments: A (MT·16 x K, shared memory,
// row stride lda), B the chunk's weight rows streamed through a ring of
// STAGES cp.async stages of KC columns, starting at stage `rot` (blocks
// start at different weight columns, so that they do not all ask the same
// L2 lines at once).  Warp w owns chunk columns [24w, 24w + 24).  Ends
// synchronised.
__device__ __forceinline__ void gemm_chunk(float (&acc)[MAX_MT][NT][4], const bf16* A, int lda,
                                           int K, int MT, const WeightRows& w, bf16* wbuf,
                                           int rot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = K / KC;
  const WeightLoads loads(w, K);
  rot %= nk;
  auto k0_of = [&](int i) { return (i + rot < nk ? i + rot : i + rot - nk) * KC; };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) loads.stage(wbuf + st * NCH * WLD, k0_of(st));
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot consumed in the previous step (every warp is past it)
    const int nxt = kc + STAGES - 1;
    if (nxt < nk) loads.stage(wbuf + (nxt % STAGES) * NCH * WLD, k0_of(nxt));
    cp_async_commit();
    const bf16* ws = wbuf + (kc % STAGES) * NCH * WLD;
    const int k0 = k0_of(kc);
    // B fragments of the stage's KC/16 k16 steps: per ldmatrix_x4, lanes
    // 8i..8i+7 address rows n0..n0+7 at k = 8i of a 32-column group.
    uint32_t bfr[NT][KC / 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n0 = (warp * NT + nt) * 8;
      if (n0 < w.nvalid)
#pragma unroll
        for (int k32 = 0; k32 < KC / 32; ++k32)
          ldmatrix_x4(&bfr[nt][4 * k32], ws + (n0 + (lane & 7)) * WLD + k32 * 32 + (lane >> 3) * 8);
    }
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
#pragma unroll
      for (int mt = 0; mt < MAX_MT; ++mt) {
        if (mt < MT) {
          uint32_t afr[4];
          ldmatrix_x4(afr, A + (mt * 16 + (lane & 15)) * lda + k0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if ((warp * NT + nt) * 8 < w.nvalid) mma_16816(acc[mt][nt], afr, &bfr[nt][ks * 2]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Frame attention of one (location, head) on the tensor cores: scores
// S = q·kᵀ (f x f, padded to 16·MQ x 8·NK), fp32 softmax on the S
// fragments with a select mask on key frames >= f, P rounded to bf16 and
// fed from registers into O = P·v.  q, k, v rows of the location start at
// row `base`; the rows read past its f frames (up to 16·⌈f/16⌉) are finite
// (the next location's, or the zeroed slack), and P is exactly 0 there.
// O row `fr` (frame) is handed to store(fr, col, o0, o1) for columns col,
// col + 1 of the head.
template <typename Store>
__device__ __forceinline__ void frame_attention(const bf16* qs, const bf16* ks, const bf16* vs,
                                                int qld, int base, int f, int d, float scale,
                                                Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int MQ = (f + 15) / 16, NK = (f + 7) / 8, DK = d / 16, DN = d / 8;
  float sacc[2][4][4];
#pragma unroll
  for (int mq = 0; mq < 2; ++mq)
#pragma unroll
    for (int nk = 0; nk < 4; ++nk)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mq][nk][e] = 0.f;
#pragma unroll
  for (int dk = 0; dk < 4; ++dk) {
    if (dk >= DK) break;
    uint32_t qa[2][4];
#pragma unroll
    for (int mq = 0; mq < 2; ++mq)
      if (mq < MQ)
        ldmatrix_x4(qa[mq], qs + (base + mq * 16 + (lane & 15)) * qld + dk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nk = 0; nk < 4; ++nk) {
      if (nk >= NK) break;
      uint32_t kb[2];
      ldmatrix_x2(kb, ks + (base + nk * 8 + (lane & 7)) * qld + dk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mq = 0; mq < 2; ++mq)
        if (mq < MQ) mma_16816(sacc[mq][nk], qa[mq], kb);
    }
  }
  // softmax over the key frames of each query row (a row's columns live in
  // the 4 lanes of a quad)
  uint32_t pa[2][2][4];   // P as the A operand: [mq][k16 step][fragment]
#pragma unroll
  for (int mq = 0; mq < 2; ++mq) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int nk = 0; nk < 4; ++nk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nk * 8 + t2 + e;
          const float v = col < f ? sacc[mq][nk][2 * half + e] * scale : -CUDART_INF_F;
          sacc[mq][nk][2 * half + e] = v;
          m = fmaxf(m, v);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int nk = 0; nk < 4; ++nk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nk * 8 + t2 + e;
          const float ev = col < f ? expf(sacc[mq][nk][2 * half + e] - m) : 0.f;
          sacc[mq][nk][2 * half + e] = ev;
          sum += ev;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
#pragma unroll
      for (int nk = 0; nk < 4; ++nk)
        pa[mq][nk >> 1][(nk & 1) * 2 + half] =
            pack_bf16(sacc[mq][nk][2 * half] * inv, sacc[mq][nk][2 * half + 1] * inv);
    }
  }
  float oacc[2][8][4];
#pragma unroll
  for (int mq = 0; mq < 2; ++mq)
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mq][dn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk >= MQ) break;   // key k16 steps: ⌈f/16⌉, as the query tiles
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      if (2 * dp >= DN) break;
      uint32_t vb[4];   // b fragments of dims 16·dp..+7 and +8..+15
      ldmatrix_x4_trans(vb, vs + (base + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * qld +
                                dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mq = 0; mq < 2; ++mq)
        if (mq < MQ) {
          mma_16816(oacc[mq][2 * dp], pa[mq][kk], vb);
          mma_16816(oacc[mq][2 * dp + 1], pa[mq][kk], vb + 2);
        }
    }
  }
#pragma unroll
  for (int mq = 0; mq < 2; ++mq)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int fr = mq * 16 + g + 8 * half;
      if (mq >= MQ || fr >= f) continue;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn)
        if (dn < DN) store(fr, dn * 8 + t2, oacc[mq][dn][2 * half], oacc[mq][dn][2 * half + 1]);
    }
}

// FUSE_OUT: the out-projection, + bo and + x run in this kernel (the
// attention output stays in shared memory) and y is the block's output.
// Otherwise the attention output goes to `o` in device memory, and the
// wrapper runs the out-projection as a second launch (c > 1024, where the
// block could keep only one location's rows of both buffers).
template <bool FUSE_OUT>
__global__ void __launch_bounds__(THREADS, 1)
temporal_block_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, const bf16* __restrict__ wq,
                      const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                      const bf16* __restrict__ wo, const float* __restrict__ bo,
                      bf16* __restrict__ o, bf16* __restrict__ y, int f, int s, int c, int heads,
                      int L, float eps, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = c / heads;
  const int rows = L * f;                 // row r = frame (r / L), location (r % L)
  const int M = (rows + 15) / 16 * 16, MT = M / 16;
  const int VR = v_rows(L, f);
  const int lda = c + 8, qld = d + 8;
  bf16* lns = reinterpret_cast<bf16*>(smem);
  bf16* obuf = lns + M * lda;             // FUSE_OUT only
  bf16* wbuf = obuf + (FUSE_OUT ? M * lda : 0);
  bf16* qs = wbuf + STAGES * NCH * WLD;
  bf16* ks = qs + M * qld;
  bf16* vs = ks + M * qld;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bi = blockIdx.y, s0 = blockIdx.x * L;
  const int nloc = min(L, s - s0);        // real locations of this block
  const size_t batch0 = (size_t)bi * f * s;
  auto grow = [&](int fr, int l) { return batch0 + (size_t)fr * s + s0 + l; };

  // x rows → lns; rows past s and pad rows are zero-filled.  The q, k, v
  // rows past the block's rows are zeroed once (read as padding frames).
  const int cv = c / 8;
  for (int idx = tid; idx < M * cv; idx += THREADS) {
    const int r = idx / cv, v = idx % cv;
    const bool ok = r < rows && r % L < nloc;
    cp_async16(lns + r * lda + v * 8, ok ? x + grow(r / L, r % L) * c + v * 8 : x, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int idx = tid; idx < 3 * (VR - rows) * qld; idx += THREADS) {
    const int buf = idx / ((VR - rows) * qld), rem = idx % ((VR - rows) * qld);
    if (buf < 2 && rows * qld + rem >= M * qld) continue;
    qs[buf * M * qld + rows * qld + rem] = f2bf(0.f);
  }
  cp_async_wait<0>();
  __syncthreads();

  // LayerNorm in place, two-pass fp32 statistics, one warp per real row.
  for (int r = warp; r < rows; r += WARPS) {
    if (r % L >= nloc) continue;
    bf16* row = lns + r * lda;
    float sum = 0.f;
    for (int i = lane; i < c; i += 32) sum += bf2f(row[i]);
    const float mu = warp_sum(sum) / c;
    float sq = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float dv = bf2f(row[i]) - mu;
      sq += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(sq) / c + eps);
    for (int i = lane; i < c; i += 32) row[i] = f2bf((bf2f(row[i]) - mu) * rstd * ln_s[i] + ln_b[i]);
  }
  __syncthreads();

  float acc[MAX_MT][NT][4];
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  for (int hi = 0; hi < heads; ++hi) {
    const int h = (hi + blockIdx.x) % heads;   // blocks start at different heads
    const size_t off = (size_t)h * d * c;
    const WeightRows wr{{wq + off, wk + off, wv + off}, d, 3 * d};
    gemm_chunk(acc, lns, lda, c, MT, wr, wbuf, blockIdx.x);
    // q | k | v → bf16, rows location-major (l·f + frame).
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = (warp * NT + nt) * 8 + t2;
        if (col >= 3 * d) continue;
        bf16* base = qs + (col / d) * M * qld + col % d;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          if (r < rows)
            *reinterpret_cast<uint32_t*>(base + ((r % L) * f + r / L) * qld) =
                pack_bf16(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    }
    __syncthreads();
    for (int l = warp; l < nloc; l += WARPS) {
      if (FUSE_OUT) {
        frame_attention(qs, ks, vs, qld, l * f, f, d, scale,
                        [&](int fr, int col, float o0, float o1) {
                          *reinterpret_cast<uint32_t*>(obuf + (fr * L + l) * lda + h * d + col) =
                              pack_bf16(o0, o1);
                        });
      } else {
        frame_attention(qs, ks, vs, qld, l * f, f, d, scale,
                        [&](int fr, int col, float o0, float o1) {
                          *reinterpret_cast<uint32_t*>(o + grow(fr, l) * c + h * d + col) =
                              pack_bf16(o0, o1);
                        });
      }
    }
    __syncthreads();
  }
  if (!FUSE_OUT) return;

  // Out-projection in 192-column chunks; y = acc + bo + x.  Rows of
  // locations past s (whose attention output was never written) are
  // computed and dropped.
  const int nchunks = (c + NCH - 1) / NCH;
  for (int ni = 0; ni < nchunks; ++ni) {
    const int n0 = (ni + blockIdx.x) % nchunks * NCH;
    const WeightRows wr{{wo + (size_t)n0 * c, wo, wo}, NCH, min(NCH, c - n0)};
    gemm_chunk(acc, obuf, lda, c, MT, wr, wbuf, blockIdx.x);
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt) {
      if (mt >= MT) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cl = (warp * NT + nt) * 8 + t2;
        if (cl >= wr.nvalid) continue;
        const int col = n0 + cl;
        const float b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          if (r >= rows || r % L >= nloc) continue;
          const size_t go = grow(r / L, r % L) * c + col;
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + go));
          *reinterpret_cast<uint32_t*>(y + go) =
              pack_bf16(acc[mt][nt][2 * half] + b0 + xv.x, acc[mt][nt][2 * half + 1] + b1 + xv.y);
        }
      }
    }
  }
}

}  // namespace
}  // namespace aat

// x, y: (b, f, s, c) bf16; wq, wk, wv, wo: (c, c) bf16 in the torch Linear
// layout (out, in); ln_s, ln_b, bo: (c,) fp32.  heads divides c; d = c /
// heads is a multiple of 16 and <= 64; c % 32 == 0; 1 <= f <= 32.
// c <= 1024: one launch, y is the block's output and o is unused.
// c > 1024: the attention output goes to o, (b, f, s, c) bf16, y is unused,
// and the caller runs the out-projection (aat_proj_residual, no sums).
AAT_EXPORT int aat_temporal_block(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wq, const void* wk, const void* wv, const void* wo,
                                  const void* bo, void* o, void* y, int b, int f, int s, int c,
                                  int heads, float eps, float scale, void* stream) {
  using namespace aat;
  if (b < 1 || s < 1 || f < 1 || f > MAX_F || heads < 1 || c % heads != 0 || c % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = c / heads;
  if (d % 16 != 0 || d > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  const bool fuse_out = c <= 1024;
  const int L = pick_locations(f, s, c, d, fuse_out);
  if (L == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L, f, c, d, fuse_out);
  auto kern = fuse_out ? temporal_block_kernel<true> : temporal_block_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + L - 1) / L, b);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<bf16*>(o), static_cast<bf16*>(y), f, s, c,
      heads, L, eps, scale);
  return static_cast<int>(cudaGetLastError());
}
