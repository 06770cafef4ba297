// Kernel 8: one resnet stage, GroupNorm-affine (+SiLU) -> 3x3 conv with zero
// padding + per-sample bias (+ residual).
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
// (cin + cout)·2 bytes of activations).  Design: an implicit GEMM with
// M = n·H·W pixels, N = cout, K = 9·cin.  A block owns a TR x TW tile of one
// image (128 pixels) and 128 output channels, and walks cin 16 channels at a
// time.  For each chunk the tile's x rows plus a one-pixel halo, (TR+2)·(TW+2)
// pixels, arrive by cp.async; they are normalised, SiLU'd (z·sigmoid(z) as
// h + h·tanh(h), h = z/2, one tanh.approx each) and rounded once into
// shared memory, with zeros for pixels outside the image, so the conv's
// zero padding comes after the activation.  The nine taps are then nine
// shifted windows of that tile, fed by ldmatrix to mma.sync (m16n8k16, bf16
// in, fp32 accumulate) against the chunk's nine 128 x 16 weight slices,
// which the wrapper packs chunk-major so that each is one contiguous read.
// One barrier per chunk: while chunk k is multiplied, chunk k + 1 is
// activated (two activation buffers) and chunk k + 2 loads (two halo
// buffers, three weight buffers).
// The TPU kernel's cin split and cout chunking were VMEM limits and have no
// counterpart here.  Epilogue: + bias (fp32) + residual (fp32), one
// rounding to bf16.
//
// Block: 8 warps, 2 along M x 4 along N, 64 x 32 outputs each; grid
// (n·ceil(H/TR)·ceil(W/TW), ceil(cout/128)).
#include "common.cuh"

namespace aat {
namespace {

constexpr int TM = 128, TN = 128, KC = 16, THREADS = 256;
constexpr int PITCH = KC + 8;  // 48-byte rows: ldmatrix reads without bank conflicts
constexpr int HALO_MAX = 264;  // (TR + 2)·(TW + 2) pixels at most, TW in {8, 16, 32, 64}
constexpr int SLOTS = (2 * HALO_MAX + THREADS - 1) / THREADS;  // halo vectors per thread

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

struct Smem {
  bf16 raw[2][HALO_MAX * KC];     // the x halo tile of a chunk, as loaded
  bf16 act[2][HALO_MAX * PITCH];  // act(x) of a chunk
  bf16 w[3][9 * TN * PITCH];      // [tap][cout row][16 channels]
};

__global__ void __launch_bounds__(THREADS)
spatial_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ sh, const bf16* __restrict__ w,
                    const float* __restrict__ bias, const bf16* __restrict__ res,
                    bf16* __restrict__ y, int H, int W, int cin, int cout, int tw_log2,
                    int tiles_h, int tiles_w, int silu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tw = 1 << tw_log2, tr = TM >> tw_log2;
  const int hc = tw + 2, hp = (tr + 2) * hc;  // halo columns, halo pixels
  int t = blockIdx.x;
  const int twi = t % tiles_w;
  t /= tiles_w;
  const int thi = t % tiles_h, img = t / tiles_h;
  const int h0 = thi * tr, w0 = twi * tw, n0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const float* ai = a + (size_t)img * cin;
  const float* bi = sh + (size_t)img * cin;

  // This thread's halo vectors (8 channels of one pixel each), fixed for
  // every chunk: the element offset of channel 0 in x, -1 outside the image,
  // -2 past the halo.
  long long src[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int idx = tid + k * THREADS, p = idx >> 1;
    const int hh = h0 + p / hc - 1, ww = w0 + p % hc - 1;
    src[k] = idx >= hp * 2 ? -2
             : hh >= 0 && hh < H && ww >= 0 && ww < W
                 ? (((long long)img * H + hh) * W + ww) * cin + (idx & 1) * 8
                 : -1;
  }

  auto load = [&](int ci0, int raw_buf, int w_buf) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (src[k] == -2) continue;
      const int idx = tid + k * THREADS;
      cp_async16(&sm.raw[raw_buf][idx * 8], src[k] >= 0 ? x + src[k] + ci0 : x,
                 src[k] >= 0 ? 16 : 0);
    }
    // the chunk's rows n0.. of w: TN x 9 taps x 16 channels, contiguous
    const bf16* wc = w + ((size_t)(ci0 / KC) * cout + n0) * 9 * KC;
#pragma unroll
    for (int k = 0; k < TN * 18 / THREADS; ++k) {
      const int idx = tid + k * THREADS;
      const int nn = idx / 18, rem = idx % 18, tap = rem >> 1, half = rem & 1;
      const bool live = n0 + nn < cout;
      cp_async16(&sm.w[w_buf][(tap * TN + nn) * PITCH + half * 8], live ? wc + idx * 8 : w,
                 live ? 16 : 0);
    }
    cp_async_commit();
  };

  // Every halo vector of this thread holds the same 8 channels of a chunk
  // (THREADS is even): their a and b are read once per chunk.
  auto activate = [&](int ci0, int buf) {
    const int half = tid & 1, ch = ci0 + half * 8;
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(ai + ch));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(ai + ch + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bi + ch));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bi + ch + 4));
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (src[k] == -2) continue;
      const int idx = tid + k * THREADS;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (src[k] >= 0) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&sm.raw[buf][idx * 8]);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
        uint32_t* ov = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float z0 = fmaf(bf2f(xv[e]), av[e], bv[e]);
          float z1 = fmaf(bf2f(xv[e + 1]), av[e + 1], bv[e + 1]);
          if (silu) {  // z·sigmoid(z) = h + h·tanh(h), h = z/2
            const float h0 = 0.5f * z0, h1 = 0.5f * z1;
            z0 = fmaf(h0, tanh_approx(h0), h0);
            z1 = fmaf(h1, tanh_approx(h1), h1);
          }
          ov[e / 2] = pack_bf16(z0, z1);
        }
      }
      *reinterpret_cast<uint4*>(&sm.act[buf][(idx >> 1) * PITCH + half * 8]) = out;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix x4 row addresses of the A fragments: lanes 0-7 rows 0-7 / k 0-7,
  // 8-15 rows 8-15 / k 0-7, 16-23 rows 0-7 / k 8-15, 24-31 rows 8-15 / k 8-15
  // -> a[0..3]; the halo pixel under output row m at tap (0, 0)
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_off[i] = ((m >> tw_log2) * hc + (m & (tw - 1))) * PITCH + (lane >> 4) * 8;
  }

  auto mma_chunk = [&](int act_buf, int w_buf) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * hc + tap % 3) * PITCH;
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], &sm.act[act_buf][a_off[i] + shift]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // two n8 tiles: lanes 0-7 n 0-7 / k 0-7, 8-15 n 0-7 / k 8-15,
        // 16-23 n 8-15 / k 0-7, 24-31 n 8-15 / k 8-15
        const int nn = wn + j * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(bfr[j], &sm.w[w_buf][(tap * TN + nn) * PITCH + ((lane >> 3) & 1) * 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_16816(acc[i][jn], af[i], &bfr[jn >> 1][(jn & 1) * 2]);
    }
  };

  const int chunks = cin / KC;
  load(0, 0, 0);
  cp_async_wait<0>();
  __syncthreads();
  activate(0, 0);
  if (chunks > 1) load(KC, 1, 1);
  for (int ck = 0; ck < chunks; ++ck) {
    cp_async_wait<0>();
    // chunk ck + 1 landed and chunk ck is activated; every warp is done with
    // chunk ck - 1, whose activation, halo and weight buffers are free
    __syncthreads();
    if (ck + 2 < chunks) load((ck + 2) * KC, ck & 1, (ck + 2) % 3);
    if (ck + 1 < chunks) activate((ck + 1) * KC, (ck + 1) & 1);
    if (n0 + wn < cout) mma_chunk(ck & 1, ck % 3);  // warps past cout skip the product
  }

  const int g = lane >> 2, tq = lane & 3;
  const float* bb = bias + (size_t)img * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm + i * 16 + g + hf * 8;
      const int hh = h0 + (m >> tw_log2), ww = w0 + (m & (tw - 1));
      if (hh >= H || ww >= W) continue;
      const size_t row = ((size_t)img * H + hh) * W + ww;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = n0 + wn + jn * 8 + tq * 2;
        if (col >= cout) continue;
        float v0 = acc[i][jn][hf * 2] + bb[col];
        float v1 = acc[i][jn][hf * 2 + 1] + bb[col + 1];
        const size_t off = row * cout + col;
        if (res != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + off);
          v0 += __low2float(r);
          v1 += __high2float(r);
        }
        *reinterpret_cast<uint32_t*>(y + off) = pack_bf16(v0, v1);
      }
    }
}

}  // namespace
}  // namespace aat

// x: (n, H, W, cin) bf16; a, sh: (n, cin) fp32; w: (cin / 16, cout, 9, 16)
// bf16, tap = 3·dy + dx; bias: (n, cout) fp32; res: (n, H, W, cout) bf16 or null;
// y: (n, H, W, cout) bf16.  cin % 16 == 0, cout % 8 == 0.
AAT_EXPORT int aat_spatial_conv(const void* x, const void* a, const void* sh, const void* w,
                                const void* bias, const void* res, void* y, int n, int H, int W,
                                int cin, int cout, int silu, void* stream) {
  using namespace aat;
  if (cin % KC != 0 || cout % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int tw_log2 = 3;  // TW: the power of two >= W, within [8, 64]
  while ((1 << tw_log2) < W && tw_log2 < 6) ++tw_log2;
  const int tr = TM >> tw_log2;
  const int tiles_h = (H + tr - 1) / tr, tiles_w = (W + (1 << tw_log2) - 1) >> tw_log2;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(spatial_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n * tiles_h * tiles_w, (cout + TN - 1) / TN);
  spatial_conv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(sh),
      static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(y), H, W, cin, cout, tw_log2, tiles_h, tiles_w, silu);
  return static_cast<int>(cudaGetLastError());
}
