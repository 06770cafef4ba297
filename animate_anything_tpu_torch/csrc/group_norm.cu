// Kernel 6: per-(sample, channel) fp32 Σx, Σx² of an (n, s, c) bf16 tensor,
// kernel 7: the one-pass GroupNorm (+SiLU) of such a tensor, and kernel 10:
// y = x + r with the sums of the stored y.
//
// Kernel 6 replaces animate_anything_tpu/ops/group_norm.py::_pallas_channel_sums
// (_stats_kernel).  Kernel 10 replaces
// animate_anything_tpu/ops/attic/add_stats.py::_pallas_add (_kernel): kernel
// 6 with the add in front (fp32 add, y rounded to bf16 and stored, the sums
// taken of the stored value), so its sums are as deterministic as kernel 6's;
// bound by device memory (x and r read once, y written once).  Kernel 7
// replaces
// animate_anything_tpu/ops/attic/streaming_group_norm.py::_pallas_group_norm
// (_gn_stream_kernel):
//     y = x·a + b in fp32, then y·sigmoid(y) in fp32, one rounding to bf16,
//     a = scale·rsqrt(var + eps), b = bias − mean·a per (sample, group),
// y·sigmoid(y) taken as y − y/(1 + e^y) (hopper.cuh's silu_tanh, as kernels 3
// and 8 take it).
//
// Bound on the H100: device memory (x read once; kernel 7 also writes y).
// Design of kernels 6 and 10: the TPU carries each sample's sums across a
// sequential row axis in one program; Hopper blocks run in no order, so the
// rows are split into chunks, in one launch.  A work item is one chunk of rows of one slab of
// 8·CT channels of one sample (CT column threads, each one 16-byte vector
// of 8 channels, CT dividing c/8, so no column thread idles) for RT row
// lanes, each thread keeping UNROLL 16-byte loads in flight; one block an
// item, the items about one wave of two blocks a SM (a second, part-full
// wave would leave most of the card idle).  An item's row lanes are added in
// a fixed tree through shared memory into an (n, chunks, c) fp32 partial
// buffer; then thread 0 takes a ticket from the (sample, slab) counter after
// the writers' __threadfence, and the block holding the last ticket adds the
// chunks' partials in a fixed order (row lanes over runs of consecutive
// chunks, then the same tree), writes the sums and resets the counter, so
// the counters need no clearing launch.  No atomics on the sums: they are
// the same from run to run.
//
// Kernel 7 (gn_stream_kernel, below) is one cooperative launch of
// persistent blocks, two a SM, all resident.  The TPU runs one program a
// sample and reads x twice (once for the sums, once for the apply).  Here
// each block takes a contiguous range of the n·s rows into shared memory by
// bulk copies: where the range fits (≈ 100 KB a block, 26 MB over the card)
// it stays there from the sums to the apply, so x is read once; where it
// does not, the first rows stay and the rest stream through a ring of copies
// in both phases, read twice.  Between the sums and the apply, two grid
// barriers around the folds: each block publishes its group sums of each
// sample it touches, and block j folds sample j's partials in block order.
// No float atomics: the sums are the same from run to run.  The barrier's
// counts only grow within a launch and the last block to finish zeroes them,
// so no clearing launch is needed.  Holding whole samples on chip and taking
// them in waves (each wave its own two barriers) read x once at every site
// but was slower at every 16-frame decode site, where the barriers cost more
// than the second read; so was a pipeline of per-sample flags, whose chains
// of latency through the fold set its pace.
#include "common.cuh"
#include "hopper.cuh"

namespace aat {
namespace {

constexpr int MAX_THREADS = 320;  // a sums block: CT column threads x RT row lanes
constexpr int SUMS_BLOCKS_PER_SM = 2;

// The row lanes' sums of each column, added in a fixed tree: at step h, lane
// ty (ty % 2h == 0) adds lane ty + h.  Lane 0 ends with the total.
__device__ __forceinline__ void tree_add(float* a1, float* a2, float* r1, float* r2, int tx,
                                         int ty, int ct, int rt) {
  for (int h = 1; h < rt; h <<= 1) {
    if (ty % (2 * h) == h) {
      float4* w1 = reinterpret_cast<float4*>(r1 + (ty * ct + tx) * 8);
      float4* w2 = reinterpret_cast<float4*>(r2 + (ty * ct + tx) * 8);
      w1[0] = make_float4(a1[0], a1[1], a1[2], a1[3]);
      w1[1] = make_float4(a1[4], a1[5], a1[6], a1[7]);
      w2[0] = make_float4(a2[0], a2[1], a2[2], a2[3]);
      w2[1] = make_float4(a2[4], a2[5], a2[6], a2[7]);
    }
    __syncthreads();
    if (ty % (2 * h) == 0 && ty + h < rt) {
      const float* o1 = r1 + ((ty + h) * ct + tx) * 8;
      const float* o2 = r2 + ((ty + h) * ct + tx) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a1[e] += o1[e];
        a2[e] += o2[e];
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store8(float* dst, const float* a) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// Kernel 6 (ADD: kernel 10, the summed rows are y = x + res, rounded to bf16
// and stored).  Grid (slabs, chunks, n), blockDim = CT·RT; chunk k holds
// rows [k·rows, (k + 1)·rows) ∩ [0, s).  p1, p2: (n, chunks, c) partials;
// tickets: one per (sample, slab), zero on entry and on exit.
template <bool ADD>
__global__ void __launch_bounds__(MAX_THREADS, SUMS_BLOCKS_PER_SM)
channel_sums_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                    bf16* __restrict__ y, float* __restrict__ p1, float* __restrict__ p2,
                    float* __restrict__ s1, float* __restrict__ s2, int* __restrict__ tickets,
                    int s, int c, int ct, int rows) {
  constexpr int UNROLL = ADD ? 4 : 8;  // 16-byte loads in flight a thread (x and r with ADD)
  __shared__ __align__(16) float r1[MAX_THREADS * 8];
  __shared__ __align__(16) float r2[MAX_THREADS * 8];
  __shared__ bool last;
  const int rt = blockDim.x / ct;
  const int tx = threadIdx.x % ct, ty = threadIdx.x / ct;
  const int slab = blockIdx.x, chunk = blockIdx.y, ni = blockIdx.z;
  const int slabs = gridDim.x, chunks = gridDim.y;
  const int col = (slab * ct + tx) * 8;  // this thread's 8 channels
  const int row1 = min((chunk + 1) * rows, s);
  float a1[8], a2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a1[e] = a2[e] = 0.f;
  const size_t at = (size_t)ni * s * c + col;
  for (int r = chunk * rows + ty; r < row1; r += UNROLL * rt) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * rt;
      if (rr < row1) raw[u] = __ldg(reinterpret_cast<const uint4*>(x + at + (size_t)rr * c));
    }
    if constexpr (ADD) {
      uint4 rv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int rr = r + u * rt;
        if (rr < row1) rv[u] = __ldg(reinterpret_cast<const uint4*>(res + at + (size_t)rr * c));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int rr = r + u * rt;
        if (rr < row1) {
          const bf16* xa = reinterpret_cast<const bf16*>(&raw[u]);
          const bf16* ra = reinterpret_cast<const bf16*>(&rv[u]);
          uint4 sum;
          bf16* sv = reinterpret_cast<bf16*>(&sum);
#pragma unroll
          for (int e = 0; e < 8; ++e) sv[e] = f2bf(bf2f(xa[e]) + bf2f(ra[e]));
          *reinterpret_cast<uint4*>(y + at + (size_t)rr * c) = sum;
          raw[u] = sum;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * rt < row1) {
        const bf16* xv = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = bf2f(xv[e]);
          a1[e] += f;
          a2[e] += f * f;
        }
      }
    }
  }
  tree_add(a1, a2, r1, r2, tx, ty, ct, rt);
  const size_t part = ((size_t)ni * chunks + chunk) * c + col;
  if (ty == 0) {
    store8(p1 + part, a1);
    store8(p2 + part, a2);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + ni * slabs + slab, 1) == chunks - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (last) {
    // The last item of the slab: row lane ty adds a run of consecutive
    // chunks, in order, of its 8 channels; then the tree.
    const int per = (chunks + rt - 1) / rt;
    const int k1 = min((ty + 1) * per, chunks);
#pragma unroll
    for (int e = 0; e < 8; ++e) a1[e] = a2[e] = 0.f;
#pragma unroll 4
    for (int k = ty * per; k < k1; ++k) {
      const size_t off = ((size_t)ni * chunks + k) * c + col;
      const float4 u0 = __ldcg(reinterpret_cast<const float4*>(p1 + off));
      const float4 u1 = __ldcg(reinterpret_cast<const float4*>(p1 + off) + 1);
      const float4 v0 = __ldcg(reinterpret_cast<const float4*>(p2 + off));
      const float4 v1 = __ldcg(reinterpret_cast<const float4*>(p2 + off) + 1);
      a1[0] += u0.x; a1[1] += u0.y; a1[2] += u0.z; a1[3] += u0.w;
      a1[4] += u1.x; a1[5] += u1.y; a1[6] += u1.z; a1[7] += u1.w;
      a2[0] += v0.x; a2[1] += v0.y; a2[2] += v0.z; a2[3] += v0.w;
      a2[4] += v1.x; a2[5] += v1.y; a2[6] += v1.z; a2[7] += v1.w;
    }
    tree_add(a1, a2, r1, r2, tx, ty, ct, rt);
    if (ty == 0) {
      store8(s1 + (size_t)ni * c + col, a1);
      store8(s2 + (size_t)ni * c + col, a2);
    }
    if (threadIdx.x == 0) tickets[ni * slabs + slab] = 0;
  }
}

// Kernel 6 on the caller's stream; work holds the (n, chunks, c) partials of
// Σx and of Σx², tickets n·slabs zeroed ints (left zeroed).  The plan
// (ops/group_norm.py::sums_plan): ct column threads (dividing c/8), threads
// = ct·RT, chunks of `rows` rows.  With res, kernel 10: the sums are those
// of y = x + res, which it stores.
int channel_sums(const bf16* x, float* work, int* tickets, float* s1, float* s2, int n, int s,
                 int c, int ct, int threads, int chunks, int rows, cudaStream_t stream,
                 const bf16* res = nullptr, bf16* y = nullptr) {
  if (c % 8 != 0 || ct < 1 || (c / 8) % ct != 0 || threads % ct != 0 || threads > MAX_THREADS ||
      chunks < 1 || chunks > 65535 || n < 1 || n > 65535 || rows < 1 ||
      (size_t)chunks * rows < (size_t)s || (size_t)(chunks - 1) * rows >= (size_t)s)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p1 = work;
  float* p2 = work + (size_t)n * chunks * c;
  dim3 grid(c / 8 / ct, chunks, n);
  if (res != nullptr)
    channel_sums_kernel<true><<<grid, threads, 0, stream>>>(x, res, y, p1, p2, s1, s2, tickets, s,
                                                             c, ct, rows);
  else
    channel_sums_kernel<false><<<grid, threads, 0, stream>>>(x, nullptr, nullptr, p1, p2, s1, s2,
                                                              tickets, s, c, ct, rows);
  return static_cast<int>(cudaGetLastError());
}

// ---- kernel 7 ---------------------------------------------------------------

constexpr int GN_THREADS = 256;  // CT = c/8 column threads x RT = 256/CT row lanes
constexpr int GN_BLOCKS_PER_SM = 2;
constexpr int GN_UNROLL = 4;         // rows a thread reads ahead from shared memory
constexpr int FOLD_UNROLL = 8;       // partials in flight a thread of the fold
constexpr uint32_t GN_COPY = 16384;  // bytes a piece: a bulk copy on its own barrier
constexpr int GN_MAX_COPIES = 8;

struct GnParams {
  const bf16* x;
  bf16* y;
  const float* scale;
  const float* bias;
  float* part;  // (n, grid, 2·groups padded to 4): each block's Σx, Σx² of a sample, by group
  float* gm;    // (n, 2, groups): each sample's group means and 1/σ
  int* bar;     // 2 zeroed ints: the grid barrier's arrivals, blocks done
  int n, s, c, groups;
  int pieces;  // shared-memory pieces a block
  int ring;    // of them streaming the rows past the others where a range does not fit
  float eps;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid (all resident) reaches it before any leaves: the
// count only grows within a launch, so a block adds its arrival (a release,
// no reply awaited) and waits for the count of the barriers passed so far.
// A wait never takes seconds: a trap rather than a hung card if one did.
__device__ __forceinline__ void grid_barrier(int* count, int& passed) {
  __syncthreads();
  ++passed;
  if (threadIdx.x == 0) {
    const int want = passed * (int)gridDim.x;
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(count) : "memory");
    for (uint32_t polls = 0; ld_acquire(count) < want; ++polls)
      if (polls == (1u << 30)) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ void add8(float* a1, float* a2, const uint4& raw) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    a1[2 * i] += f.x;
    a2[2 * i] = fmaf(f.x, f.x, a2[2 * i]);
    a1[2 * i + 1] += f.y;
    a2[2 * i + 1] = fmaf(f.y, f.y, a2[2 * i + 1]);
  }
}

// The eight values a pass at a time, so the special-function ops of one
// row are in flight together.
template <bool SILU>
__device__ __forceinline__ uint4 apply8(const uint4& raw, const float* av, const float* bv) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float z[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    z[2 * i] = fmaf(f.x, av[2 * i], bv[2 * i]);
    z[2 * i + 1] = fmaf(f.y, av[2 * i + 1], bv[2 * i + 1]);
  }
  if (SILU) {
#pragma unroll
    for (int i = 0; i < 8; ++i) z[i] = hopper::silu_tanh(z[i]);
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = pack_bf16(z[2 * i], z[2 * i + 1]);
  return out;
}

// Kernel 7: three phases between two grid barriers.  The n·s rows are split
// into G contiguous ranges of R rows, one a block.  A block's shared memory
// is `pieces` pieces of up to GN_COPY bytes, each filled by one bulk copy on
// its own barrier.  Where the range fits, every piece holds its rows for the
// whole launch; else the first pieces do and the last `ring` pieces stream
// the other rows, copies `ring` deep in flight, in both the sums and the
// apply.  (1) The block adds each sample's per-channel Σx, Σx² over its rows
// in a fixed order, then its group sums, to the partials.  (2) Block b folds
// sample b (b + G, ...): the partials of the blocks whose ranges meet it, in
// block order, into the groups' mean and 1/σ with the arithmetic of the
// plain version.  (3) Each block applies y = x·a + b (+ SiLU), fp32, one
// rounding, to its range, the held rows from where they lie.
template <bool SILU>
__global__ void __launch_bounds__(GN_THREADS, GN_BLOCKS_PER_SM)
gn_stream_kernel(const __grid_constant__ GnParams p) {
  using namespace hopper;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[GN_MAX_COPIES];
  const int c = p.c, ct = c / 8, rt = GN_THREADS / ct;
  const int tid = threadIdx.x, tx = tid % ct, ty = tid / ct;
  const bool lane = ty < rt;  // threads past ct·rt idle in the row loops
  const int G = gridDim.x, b = blockIdx.x;
  const size_t row_bytes = (size_t)c * 2;
  const int vals = 2 * p.groups, vpad = (vals + 3) / 4 * 4, gs = c / p.groups;
  const int prow = max(1, (int)(GN_COPY / row_bytes));  // rows a piece
  const uint32_t piece_bytes = (uint32_t)(prow * row_bytes);
  float* red = reinterpret_cast<float*>(smem + (size_t)p.pieces * piece_bytes);
  float* tot = red + 2 * GN_THREADS * 8;  // (2, c): the block's channel sums of a sample
  float* sb = tot + 2 * c;                // (2, c): the GroupNorm scale and bias
  // the block's range [r0, r1) of the n·s rows: the first `held` rows in
  // pieces [0, hp), the others through the ring, pieces [hp, hp + ring)
  const int R = (p.n * p.s + G - 1) / G;
  const int r0 = min(p.n * p.s, b * R), r1 = min(p.n * p.s, r0 + R);
  const bool fits = r1 - r0 <= p.pieces * prow;
  const int ring = fits ? 0 : p.ring, hp = fits ? (r1 - r0 + prow - 1) / prow : p.pieces - ring;
  const int held = min(r1 - r0, hp * prow), chunks = (r1 - r0 - held + prow - 1) / prow;
  auto piece = [&](int i) { return smem + (size_t)i * piece_bytes; };
  // Thread 0: rows [r, min(r + prow, r1)) into piece i, on its barrier.
  auto copy = [&](int i, int r) {
    const uint32_t bar = smem_u32(&bars[i]);
    const uint32_t bytes = (uint32_t)(min(prow, r1 - r) * row_bytes);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(piece(i)), p.x + (size_t)r * c, bytes, bar);
  };
  int loads = 0;  // ring copies issued: copy m into piece hp + m % ring, parity (m / ring) & 1
  auto ring_issue = [&](int q) {  // chunk q (of this pass) into the ring, thread 0
    copy(hp + loads % ring, r0 + held + q * prow);
    ++loads;
  };

  if (tid == 0) {
    for (int i = 0; i < hp + ring; ++i) mbar_init(smem_u32(&bars[i]), 1);
    fence_barrier_init();
    for (int i = 0; i < hp; ++i) copy(i, r0 + i * prow);
    for (int q = 0; q < min(ring, chunks); ++q) ring_issue(q);
  }
  for (int ch = tid; ch < c; ch += GN_THREADS) {
    sb[ch] = p.scale[ch];
    sb[c + ch] = p.bias[ch];
  }
  __syncthreads();

  // Rows [lo, hi) of a piece whose first row is `first`, thread (tx, ty)
  // taking rows lo + ty, lo + ty + rt, ... in order.
  auto rows_in = [&](const uint8_t* pc, int first, int lo, int hi, auto&& each) {
    if (!lane) return;
    for (int r = lo + ty; r < hi; r += GN_UNROLL * rt) {
      uint4 raw[GN_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
        if (r + u * rt < hi)
          raw[u] = *reinterpret_cast<const uint4*>(pc + (r + u * rt - first) * row_bytes + 16 * tx);
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
        if (r + u * rt < hi) each(r + u * rt, raw[u]);
    }
  };
  // Every row of the range in order, piece by piece (held, then the ring:
  // each chunk's copy waited, and the chunk `ring` ahead issued once it is
  // read), in runs of one sample: run(j, pc, first, lo, hi), then done(j)
  // after a sample's last run.
  int base_load = 0;  // ring copies issued before this pass
  auto pass = [&](auto&& run, auto&& done) {
    int j = r0 / p.s;
    auto rows = [&](const uint8_t* pc, int first, int lo, int hi) {
      for (int x = lo; x < hi;) {
        const int jx = x / p.s;
        if (jx != j) {
          done(j);
          j = jx;
        }
        const int x1 = min(hi, (jx + 1) * p.s);
        run(j, pc, first, x, x1);
        x = x1;
      }
    };
    for (int i = 0; i < hp; ++i) {
      mbar_wait(smem_u32(&bars[i]), 0);  // a held piece lands once: later waits return at once
      const int lo = r0 + i * prow;
      rows(piece(i), lo, lo, min(r1, lo + prow));
    }
    for (int q = 0; q < chunks; ++q) {
      const int m = base_load + q, slot = hp + m % ring;
      mbar_wait(smem_u32(&bars[slot]), (m / ring) & 1);
      const int lo = r0 + held + q * prow;
      rows(piece(slot), lo, lo, min(r1, lo + prow));
      __syncthreads();  // the chunk is read: its piece takes the chunk `ring` ahead
      if (tid == 0 && q + ring < chunks) ring_issue(q + ring);
    }
    if (r1 > r0) done(j);
    base_load += chunks;
  };

  // ---- (1) sums ------------------------------------------------------------
  float a1[8], a2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a1[e] = a2[e] = 0.f;
  pass(
      [&](int, const uint8_t* pc, int first, int lo, int hi) {
        rows_in(pc, first, lo, hi, [&](int, const uint4& raw) { add8(a1, a2, raw); });
      },
      [&](int j) {  // the row lanes in order, then the groups' channels in order
        if (lane) {
          float4* w1 = reinterpret_cast<float4*>(red + ty * c + 8 * tx);
          float4* w2 = reinterpret_cast<float4*>(red + (rt + ty) * c + 8 * tx);
          w1[0] = make_float4(a1[0], a1[1], a1[2], a1[3]);
          w1[1] = make_float4(a1[4], a1[5], a1[6], a1[7]);
          w2[0] = make_float4(a2[0], a2[1], a2[2], a2[3]);
          w2[1] = make_float4(a2[4], a2[5], a2[6], a2[7]);
        }
        __syncthreads();
        for (int ch = tid; ch < c; ch += GN_THREADS) {
          float t1 = 0.f, t2 = 0.f;
          for (int l = 0; l < rt; ++l) {
            t1 += red[l * c + ch];
            t2 += red[(rt + l) * c + ch];
          }
          tot[ch] = t1;
          tot[c + ch] = t2;
        }
        __syncthreads();
        float* dst = p.part + ((size_t)j * G + b) * vpad;
        for (int g = tid; g < p.groups; g += GN_THREADS) {
          float g1 = 0.f, g2 = 0.f;
          for (int i = 0; i < gs; ++i) {
            g1 += tot[g * gs + i];
            g2 += tot[c + g * gs + i];
          }
          dst[g] = g1;
          dst[p.groups + g] = g2;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) a1[e] = a2[e] = 0.f;
      });
  if (tid == 0)  // the ring's first chunks again, for the apply
    for (int q = 0; q < min(ring, chunks); ++q) ring_issue(q);
  int passed = 0;  // grid barriers passed
  grid_barrier(p.bar, passed);

  // ---- (2) the folds: block b takes samples b, b + G, ... ---------------------
  const int v4s = vpad / 4, lanes = max(1, GN_THREADS / v4s);
  for (int j = b; j < p.n; j += G) {
    // blocks whose ranges meet the sample's rows [j·s, (j + 1)·s)
    const int b0 = j * p.s / R, b1 = min(G - 1, ((j + 1) * p.s - 1) / R);
    const float4* src = reinterpret_cast<const float4*>(p.part + (size_t)j * G * vpad);
    const int v = tid % v4s, l = tid / v4s;
    if (l < lanes && tid < v4s * lanes) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = b0 + l; k <= b1; k += FOLD_UNROLL * lanes) {
        float4 u[FOLD_UNROLL];
#pragma unroll
        for (int q = 0; q < FOLD_UNROLL; ++q)
          if (k + q * lanes <= b1) u[q] = __ldcg(src + (size_t)(k + q * lanes) * v4s + v);
#pragma unroll
        for (int q = 0; q < FOLD_UNROLL; ++q)
          if (k + q * lanes <= b1) {
            t.x += u[q].x;
            t.y += u[q].y;
            t.z += u[q].z;
            t.w += u[q].w;
          }
      }
      reinterpret_cast<float4*>(red)[l * v4s + v] = t;
    }
    __syncthreads();
    for (int g = tid; g < p.groups; g += GN_THREADS) {
      float g1 = 0.f, g2 = 0.f;
      for (int i = 0; i < lanes; ++i) {
        g1 += red[i * vpad + g];
        g2 += red[i * vpad + p.groups + g];
      }
      const float cnt = (float)p.s * (float)gs;
      const float mean = g1 / cnt;
      const float var = g2 / cnt - mean * mean;
      p.gm[(size_t)j * vals + g] = mean;
      p.gm[(size_t)j * vals + p.groups + g] = 1.f / sqrtf(fmaxf(var, 0.f) + p.eps);
    }
    __syncthreads();
  }
  grid_barrier(p.bar, passed);

  // ---- (3) the apply --------------------------------------------------------
  float av[8], bv[8];  // the affine of the thread's 8 channels, as the plain version's
  int ab = -1;         // the sample they are for
  pass(
      [&](int j, const uint8_t* pc, int first, int lo, int hi) {
        if (ab != j) {
          const float* gj = p.gm + (size_t)j * vals;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int ch = lane ? 8 * tx + e : 0, g = ch / gs;
            const float mean = __ldcg(gj + g), inv = __ldcg(gj + p.groups + g);
            av[e] = inv * sb[ch];
            bv[e] = sb[c + ch] - mean * av[e];
          }
          ab = j;
        }
        rows_in(pc, first, lo, hi, [&](int r, const uint4& raw) {
          __stcs(reinterpret_cast<uint4*>(p.y + (size_t)r * c + 8 * tx),
                 apply8<SILU>(raw, av, bv));
        });
      },
      [](int) {});
  // The last block to finish zeroes the counts: every block has passed every
  // barrier.
  if (tid == 0 && atomicAdd(p.bar + 1, 1) == G - 1) {
    atomicExch(p.bar, 0);
    atomicExch(p.bar + 1, 0);
  }
}

}  // namespace
}  // namespace aat

// x: (n, s, c) bf16; work: 2·n·chunks·c fp32 scratch; tickets: n·slabs
// zeroed ints (left zeroed); s1, s2: (n, c) fp32.  c % 8 == 0.
AAT_EXPORT int aat_channel_sums(const void* x, void* work, void* tickets, void* s1, void* s2,
                                int n, int s, int c, int ct, int threads, int chunks, int rows,
                                void* stream) {
  return aat::channel_sums(static_cast<const aat::bf16*>(x), static_cast<float*>(work),
                           static_cast<int*>(tickets), static_cast<float*>(s1),
                           static_cast<float*>(s2), n, s, c, ct, threads, chunks, rows,
                           static_cast<cudaStream_t>(stream));
}

// x, r, y: (n, s, c) bf16; work, tickets as above; s1, s2: (n, c) fp32
// sums of the stored y.  c % 8 == 0.
AAT_EXPORT int aat_add_stats(const void* x, const void* r, void* y, void* work, void* tickets,
                             void* s1, void* s2, int n, int s, int c, int ct, int threads,
                             int chunks, int rows, void* stream) {
  return aat::channel_sums(static_cast<const aat::bf16*>(x), static_cast<float*>(work),
                           static_cast<int*>(tickets), static_cast<float*>(s1),
                           static_cast<float*>(s2), n, s, c, ct, threads, chunks, rows,
                           static_cast<cudaStream_t>(stream), static_cast<const aat::bf16*>(r),
                           static_cast<aat::bf16*>(y));
}

// Kernel 7.  x, y: (n, s, c) bf16; scale, bias: (c,) fp32; work: n·grid·p +
// n·2·groups fp32 scratch, p = 2·groups rounded up to 4 (the partials, then
// the group statistics); bar: 2 zeroed ints (left zeroed).  The launch plan
// (ops/streaming_group_norm.py::launch_plan): `pieces` shared-memory pieces
// of GN_COPY bytes a block, the last `ring` of them streaming where a range
// does not fit, grid blocks of dynamic shared bytes `smem`, all resident (a
// cooperative launch, refused otherwise: two a SM at most).  c % 8 == 0,
// c <= 2048, c % groups == 0, 2·groups <= 1024.
AAT_EXPORT int aat_group_norm(const void* x, const void* scale, const void* bias, void* work,
                              void* bar, void* y, int n, int s, int c, int groups, int pieces,
                              int ring, int grid, int smem, float eps, int silu, void* stream) {
  using namespace aat;
  const size_t row_bytes = (size_t)c * 2, piece = GN_COPY / row_bytes * row_bytes;
  if (n < 1 || s < 1 || c < 8 || c % 8 != 0 || c > 8 * GN_THREADS || groups < 1 ||
      c % groups != 0 || 2 * groups > 4 * GN_THREADS || pieces < 2 || pieces > GN_MAX_COPIES ||
      ring < 1 || ring >= pieces || grid < 1 || (size_t)n * s >= (1u << 31) ||
      (size_t)smem < pieces * piece + (2 * GN_THREADS * 8 + 4 * (size_t)c) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(work);
  GnParams p = {static_cast<const bf16*>(x), static_cast<bf16*>(y),
                static_cast<const float*>(scale), static_cast<const float*>(bias), w,
                w + (size_t)n * grid * ((2 * groups + 3) / 4 * 4), static_cast<int*>(bar), n, s,
                c, groups, pieces, ring, eps};
  void* kernel = silu ? reinterpret_cast<void*>(gn_stream_kernel<true>)
                      : reinterpret_cast<void*>(gn_stream_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(GN_THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
