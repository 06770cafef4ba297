// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel is exposed through a plain C function that takes raw device
// pointers, shapes and the CUDA stream, launches on that stream, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#define AAT_EXPORT extern "C" __attribute__((visibility("default")))

namespace aat {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and r[i] receives, in lane
// (g = lane / 4, t = lane % 4), elements [g][2t..2t+1] of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// Two matrices: lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
// Transposed: r[i] receives elements [2t][g] and [2t+1][g] of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two floats -> one .b32 register of two bf16, `lo` in the low half (the
// lower-indexed element of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D += A·B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 fp32.  Fragment layout (PTX ISA, mma.m16n8k16): with g = lane / 4
// and t = lane % 4,
//   a[0] = A[g][2t..2t+1]    a[1] = A[g+8][2t..]   a[2] = A[g][2t+8..]
//   a[3] = A[g+8][2t+8..]    b[0] = B[2t..2t+1][g] b[1] = B[2t+8..][g]
//   d[0..1] = D[g][2t..2t+1] d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous 16-byte global -> shared copies (sm_80+).  With src_bytes = 0
// the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Epilogue shared by the tap-conv and proj-residual kernels.  The block's
// GEMM tile sits in shared memory as Cs (TM x CLD fp32) and covers rows
// [m0, min(m0 + TM, M)) of the flattened (M, N) output: y = C + bias
// (+ residual) is stored as bf16, and Σy, Σy² of the STORED values are added
// into the per-(slab, channel) fp32 sums, a slab being slab_rows consecutive
// rows.  Blocks finish in no order, so the sums are fp32 atomics into buffers
// the wrapper zeroed, one per column and slab run of the tile.  With s1 null
// only y is stored.
template <int TM, int TN, int THREADS, int CLD>
__device__ __forceinline__ void bias_residual_stats(
    const float* Cs, const float* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ y, float* __restrict__ s1, float* __restrict__ s2, int m0, int M,
    int slab_rows, int n0, int N) {
  constexpr int PART_ROWS = TM / (THREADS / TN);
  const int col = threadIdx.x % TN, part = threadIdx.x / TN;
  const int gc = n0 + col;
  const int r_begin = part * PART_ROWS;
  const int r_end = min(r_begin + PART_ROWS, M - m0);
  if (gc >= N || r_end <= r_begin) return;
  const float bv = bias[gc];
  int slab = (m0 + r_begin) / slab_rows;
  int slab_end = (slab + 1) * slab_rows;
  float a1 = 0.f, a2 = 0.f;
  const bool sums = s1 != nullptr;
  for (int r = r_begin; r < r_end; ++r) {
    const int row = m0 + r;
    if (sums && row == slab_end) {
      atomicAdd(s1 + (size_t)slab * N + gc, a1);
      atomicAdd(s2 + (size_t)slab * N + gc, a2);
      a1 = a2 = 0.f;
      ++slab;
      slab_end += slab_rows;
    }
    const size_t off = (size_t)row * N + gc;
    float v = Cs[r * CLD + col] + bv;
    if (res != nullptr) v += bf2f(res[off]);
    const bf16 vb = f2bf(v);
    y[off] = vb;
    const float vr = bf2f(vb);
    a1 += vr;
    a2 += vr * vr;
  }
  if (!sums) return;
  atomicAdd(s1 + (size_t)slab * N + gc, a1);
  atomicAdd(s2 + (size_t)slab * N + gc, a2);
}

}  // namespace aat
