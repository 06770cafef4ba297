// Kernel 6: per-(sample, channel) fp32 Σx, Σx² of an (n, s, c) bf16 tensor,
// kernel 7: the one-pass GroupNorm (+SiLU) built on those sums, and kernel 10:
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
//     a = scale·rsqrt(var + eps), b = bias − mean·a per (sample, group).
//
// Bound on the H100: device memory (x read once; kernel 7 also writes y).
// Design: the TPU carries each sample's sums across a sequential row axis in
// one program; Hopper blocks run in no order, so the rows are split into
// chunks, in one launch.  A work item is one chunk of rows of one slab of
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
// the same from run to run.  The TPU's
// one-program-per-sample GroupNorm would fill 16 of 132 SMs at the VAE's 16
// frames, so kernel 7 is the sum kernel, a fold into per-(sample, channel)
// fp32 (a, b), and one apply pass over every block: x is read twice, y
// written once.
#include "common.cuh"

namespace aat {
namespace {

constexpr int THREADS = 256;      // the apply pass
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

// Per (sample, group): the group's moments from its channels' sums, folded
// with the GroupNorm scale and bias into per-channel fp32 (a, b), as
// group_affine does.  One block per sample, one thread per group.
__global__ void group_fold_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                                  const float* __restrict__ scale, const float* __restrict__ bias,
                                  float* __restrict__ a, float* __restrict__ b, int s, int c,
                                  int groups, float eps) {
  const int ni = blockIdx.x, gs = c / groups;
  const float cnt = (float)s * (float)gs;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const size_t base = (size_t)ni * c + (size_t)g * gs;
    float g1 = 0.f, g2 = 0.f;
    for (int j = 0; j < gs; ++j) {
      g1 += s1[base + j];
      g2 += s2[base + j];
    }
    const float mean = g1 / cnt;
    const float var = g2 / cnt - mean * mean;
    const float inv = 1.f / sqrtf(fmaxf(var, 0.f) + eps);
    for (int j = 0; j < gs; ++j) {
      const float av = inv * scale[g * gs + j];
      a[base + j] = av;
      b[base + j] = bias[g * gs + j] - mean * av;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, bf16* __restrict__ y, size_t vecs, int s, int c,
                int silu) {
  const int v = c / 8;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < vecs;
       i += (size_t)gridDim.x * THREADS) {
    const size_t ni = i / ((size_t)s * v);
    const int ch = (int)(i % v) * 8;
    const float* av = a + ni * c + ch;
    const float* bv = b + ni * c + ch;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    uint4 out;
    bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float z = fmaf(bf2f(xv[e]), __ldg(av + e), __ldg(bv + e));
      if (silu) z = z / (1.f + __expf(-z));
      ov[e] = f2bf(z);
    }
    reinterpret_cast<uint4*>(y)[i] = out;
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

// x, y: (n, s, c) bf16; scale, bias: (c,) fp32; work: 2·n·chunks·c + 4·n·c
// fp32 scratch (partials, sums, a, b); tickets as above.  c % 8 == 0,
// c % groups == 0.
AAT_EXPORT int aat_group_norm(const void* x, const void* scale, const void* bias, void* work,
                              void* tickets, void* y, int n, int s, int c, int groups, int ct,
                              int threads, int chunks, int rows, float eps, int silu,
                              void* stream) {
  using namespace aat;
  if (c % 8 != 0 || groups < 1 || c % groups != 0 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  const size_t nc = (size_t)n * c;
  float* s1 = w + 2 * (size_t)chunks * nc;
  float* s2 = s1 + nc;
  float* a = s2 + nc;
  float* b = a + nc;
  const bf16* xb = static_cast<const bf16*>(x);
  int err = channel_sums(xb, w, static_cast<int*>(tickets), s1, s2, n, s, c, ct, threads, chunks,
                         rows, st);
  if (err != 0) return err;
  group_fold_kernel<<<n, 32, 0, st>>>(s1, s2, static_cast<const float*>(scale),
                                      static_cast<const float*>(bias), a, b, s, c, groups, eps);
  const cudaError_t fold = cudaGetLastError();
  if (fold != cudaSuccess) return static_cast<int>(fold);
  const size_t vecs = (size_t)n * s * c / 8;
  const size_t want = (vecs + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gn_apply_kernel<<<blocks, THREADS, 0, st>>>(xb, a, b, static_cast<bf16*>(y), vecs, s, c, silu);
  return static_cast<int>(cudaGetLastError());
}
