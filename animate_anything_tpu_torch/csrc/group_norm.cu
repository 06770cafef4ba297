// Kernel 6: per-(sample, channel) fp32 Σx, Σx² of an (n, s, c) bf16 tensor,
// kernel 7: the one-pass GroupNorm (+SiLU) built on those sums, and kernel 10:
// y = x + r with the sums of the stored y.
//
// Kernel 6 replaces animate_anything_tpu/ops/group_norm.py::_pallas_channel_sums
// (_stats_kernel).  Kernel 10 replaces
// animate_anything_tpu/ops/attic/add_stats.py::_pallas_add (_kernel): kernel
// 6's first pass with the add in front (fp32 add, y rounded to bf16 and
// stored, the sums taken of the stored value) and the same fixed-order second
// pass, so its sums are as deterministic as kernel 6's; bound by device memory
// (x and r read once, y written once).  Kernel 7 replaces
// animate_anything_tpu/ops/attic/streaming_group_norm.py::_pallas_group_norm
// (_gn_stream_kernel):
//     y = x·a + b in fp32, then y·sigmoid(y) in fp32, one rounding to bf16,
//     a = scale·rsqrt(var + eps), b = bias − mean·a per (sample, group).
//
// Bound on the H100: device memory (x read once; kernel 7 also writes y).
// Design: the TPU carries each sample's sums across a sequential row axis in
// one program; Hopper blocks run in no order, so the rows are split into
// chunks over many blocks.  A block owns 8·CT channels (CT = min(32, c/8)
// threads along c, one 16-byte load of 8 channels each, so a warp reads
// contiguous rows) and one chunk of rows; its RT = 256/CT row lanes are
// summed through shared memory into an (n, chunks, c) fp32 partial buffer,
// and a second pass adds the chunks in a fixed order.  No atomics: the sums
// are the same from run to run.  The TPU's one-program-per-sample GroupNorm
// would fill 16 of 132 SMs at the VAE's 16 frames, so kernel 7 is the two
// sum passes, a fold into per-(sample, channel) fp32 (a, b), and one apply
// pass over every block: x is read twice, y written once.
#include "common.cuh"

namespace aat {
namespace {

constexpr int THREADS = 256;

// ADD: the summed rows are y = x + res, rounded to bf16 and stored.
template <bool ADD>
__global__ void __launch_bounds__(THREADS)
channel_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                       bf16* __restrict__ y, float* __restrict__ p1, float* __restrict__ p2,
                       int s, int c, int rows_per_chunk, int ct) {
  __shared__ __align__(16) float r1[THREADS * 8];
  __shared__ __align__(16) float r2[THREADS * 8];
  const int rt = THREADS / ct;
  const int tx = threadIdx.x % ct, ty = threadIdx.x / ct;
  const int cv = blockIdx.x * ct + tx;  // this thread's 8-channel vector
  const int chunk = blockIdx.y, ni = blockIdx.z;
  const int row0 = chunk * rows_per_chunk;
  const int row1 = min(row0 + rows_per_chunk, s);
  float a1[8], a2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a1[e] = a2[e] = 0.f;
  if (ty < rt && cv * 8 < c) {
    const size_t at = (size_t)ni * s * c + (size_t)cv * 8;
#pragma unroll 4
    for (int r = row0 + ty; r < row1; r += rt) {
      const size_t off = at + (size_t)r * c;
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + off));
      if constexpr (ADD) {
        const uint4 rr = __ldg(reinterpret_cast<const uint4*>(res + off));
        const bf16* xa = reinterpret_cast<const bf16*>(&raw);
        const bf16* ra = reinterpret_cast<const bf16*>(&rr);
        uint4 sum;
        bf16* sv = reinterpret_cast<bf16*>(&sum);
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[e] = f2bf(bf2f(xa[e]) + bf2f(ra[e]));
        *reinterpret_cast<uint4*>(y + off) = sum;
        raw = sum;
      }
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = bf2f(xv[e]);
        a1[e] += f;
        a2[e] += f * f;
      }
    }
  }
  float4* o1 = reinterpret_cast<float4*>(r1 + threadIdx.x * 8);
  float4* o2 = reinterpret_cast<float4*>(r2 + threadIdx.x * 8);
  o1[0] = make_float4(a1[0], a1[1], a1[2], a1[3]);
  o1[1] = make_float4(a1[4], a1[5], a1[6], a1[7]);
  o2[0] = make_float4(a2[0], a2[1], a2[2], a2[3]);
  o2[1] = make_float4(a2[4], a2[5], a2[6], a2[7]);
  __syncthreads();
  // column j = 8·tx + e of the block's slab: its RT row lanes, in order
  for (int j = threadIdx.x; j < ct * 8; j += THREADS) {
    const int ch = blockIdx.x * ct * 8 + j;
    if (ch >= c) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < rt; ++t) {
      s1 += r1[t * ct * 8 + j];
      s2 += r2[t * ct * 8 + j];
    }
    const size_t off = ((size_t)ni * gridDim.y + chunk) * c + ch;
    p1[off] = s1;
    p2[off] = s2;
  }
}

// (n, chunks, c) partials -> (n, c) sums, the chunks added in order.
__global__ void channel_finish_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                                      float* __restrict__ s1, float* __restrict__ s2, int n,
                                      int c, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * c) return;
  const int ni = i / c, ch = i % c;
  const float* q1 = p1 + (size_t)ni * chunks * c + ch;
  const float* q2 = p2 + (size_t)ni * chunks * c + ch;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    a += q1[(size_t)k * c];
    b += q2[(size_t)k * c];
  }
  s1[i] = a;
  s2[i] = b;
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

// The two passes of kernel 6 on the caller's stream; work holds the
// (n, chunks, c) partials of Σx and of Σx².  With res, kernel 10: the sums
// are those of y = x + res, which the first pass stores.
int channel_sums(const bf16* x, float* work, float* s1, float* s2, int n, int s, int c,
                 int chunks, cudaStream_t stream, const bf16* res = nullptr,
                 bf16* y = nullptr) {
  const int ct = min(32, c / 8);
  const int rows_per_chunk = (s + chunks - 1) / chunks;
  float* p1 = work;
  float* p2 = work + (size_t)n * chunks * c;
  dim3 grid((c / 8 + ct - 1) / ct, chunks, n);
  if (res != nullptr)
    channel_partial_kernel<true><<<grid, THREADS, 0, stream>>>(x, res, y, p1, p2, s, c,
                                                               rows_per_chunk, ct);
  else
    channel_partial_kernel<false><<<grid, THREADS, 0, stream>>>(x, nullptr, nullptr, p1, p2, s,
                                                                c, rows_per_chunk, ct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_finish_kernel<<<(n * c + THREADS - 1) / THREADS, THREADS, 0, stream>>>(p1, p2, s1, s2,
                                                                               n, c, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aat

// x: (n, s, c) bf16; work: 2·n·chunks·c fp32 scratch; s1, s2: (n, c) fp32.
// c % 8 == 0, 1 <= chunks.
AAT_EXPORT int aat_channel_sums(const void* x, void* work, void* s1, void* s2, int n, int s,
                                int c, int chunks, void* stream) {
  if (c % 8 != 0 || chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return aat::channel_sums(static_cast<const aat::bf16*>(x), static_cast<float*>(work),
                           static_cast<float*>(s1), static_cast<float*>(s2), n, s, c, chunks,
                           static_cast<cudaStream_t>(stream));
}

// x, r, y: (n, s, c) bf16; work: 2·n·chunks·c fp32 scratch; s1, s2: (n, c)
// fp32 sums of the stored y.  c % 8 == 0, 1 <= chunks.
AAT_EXPORT int aat_add_stats(const void* x, const void* r, void* y, void* work, void* s1,
                             void* s2, int n, int s, int c, int chunks, void* stream) {
  if (c % 8 != 0 || chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return aat::channel_sums(static_cast<const aat::bf16*>(x), static_cast<float*>(work),
                           static_cast<float*>(s1), static_cast<float*>(s2), n, s, c, chunks,
                           static_cast<cudaStream_t>(stream), static_cast<const aat::bf16*>(r),
                           static_cast<aat::bf16*>(y));
}

// x, y: (n, s, c) bf16; scale, bias: (c,) fp32; work: 2·n·chunks·c + 4·n·c
// fp32 scratch (partials, sums, a, b).  c % 8 == 0, c % groups == 0.
AAT_EXPORT int aat_group_norm(const void* x, const void* scale, const void* bias, void* work,
                              void* y, int n, int s, int c, int groups, int chunks, float eps,
                              int silu, void* stream) {
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
  int err = channel_sums(xb, w, s1, s2, n, s, c, chunks, st);
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
