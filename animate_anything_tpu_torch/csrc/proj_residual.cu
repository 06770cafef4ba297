// Kernel 4: transformer output projection + bias + residual, with a
// per-(row slab, channel) Σy / Σy² epilogue of the stored output, on TMA
// and wgmma.
//
// Replaces animate_anything_tpu/ops/proj_residual.py::_pallas_proj (_kernel):
//     y[n, s] = h[n, s]·W + bias + residual[n, s]
// The consumer of y is always a GroupNorm, which takes the sums through
// group_affine(sums=) instead of reading y again.
//
// Bound on the H100: at the UNet's large sites (s = 4096, k <= 512,
// c = 320) the bytes, (k + 2c)·2 a row against 2·k·c flops; at c = 1280 the
// tensor cores.  Design: the slab form of the persistent TMA + wgmma
// residual GEMM in gemm.cuh (kernel 2's second GEMM and kernel 5's
// out-projection), instantiated under this kernel's owner tag:
// - h, the residual and y are 3-D maps (cols, s, n), so each warpgroup's
//   64-row sub-tile lies within one slab n: rows past s read as zeros and
//   are neither stored nor summed, two sub-tiles make a 128-row tile (s =
//   64, the c = 1280 site, fills whole tiles with two slabs), and ragged s
//   stays exact;
// - the residual tile is TMA-loaded into the warpgroup's output tile
//   during the mainloop; the epilogue adds bias and residual in fp32 over
//   it, rounds to bf16 and stores it with one TMA store;
// - then each warpgroup sums its stored tile's columns over the slab's rows
//   into per-sub-tile partials, which a tree of tickets adds in one fixed
//   order (gemm.cuh's slab sums), as kernel 3 does: the TPU accumulated
//   them on a sequential grid axis, one fixed order, and so does this,
//   though Hopper blocks finish in no order;
// - the tile width comes from the wrapper's launch plan
//   (ops/proj_residual.py::launch_plan), the fewest waves of tile work
//   (ops/geglu.py::pick_width): 160 at c = 320 and 640, where 64-column
//   tiles read A five times; 256 at c = 1280.  At s = 64 the 34 slabs make
//   17 row tiles, so 256 columns give 85 tiles, one wave that leaves 47 of
//   the 132 SMs idle, against two waves of 136 tiles at 160 or 170 at 128;
//   on the H100 the three widths time level there (PERF.md §6, row 10).
//   With ring depth, grid and shared-memory bytes.
#include "gemm.cuh"

// h: (n, s, k) bf16; w: (c, k) bf16 (torch Linear layout); bias: (c,) fp32;
// res, y: (n, s, c) bf16; s1, s2: (n, c) fp32, written; part: fp32 scratch
// and tickets: zeroed ints, left zeroed, as many as aat_slab_sums_sizes
// gives for (n, s, c, ⌈c/bn⌉) (part unused, may be null, at s <= 64).
// k % 8 == 0, c % 8 == 0, all 16-byte aligned.  The launch plan: tile width bn (256, 160, 128 or 64 output
// columns), ring stages, persistent grid and dynamic shared bytes.
AAT_EXPORT int aat_proj_residual(const void* h, const void* w, const void* bias, const void* res,
                                 void* y, void* s1, void* s2, void* part, void* tickets, int n,
                                 int s, int k, int c, int bn, int stages, int grid, int smem,
                                 void* stream) {
  using namespace aat;
  if (k % 8 != 0 || c % 8 != 0 || k < 8 || c < 8) return static_cast<int>(cudaErrorInvalidValue);
  return gemm::gemm_bias_residual_stats<proj_residual>(
      h, w, bias, res, y, static_cast<float*>(s1), static_cast<float*>(s2),
      static_cast<float*>(part), static_cast<int*>(tickets), n, s, c, k, bn, stages, grid, smem,
      static_cast<cudaStream_t>(stream));
}

// The sizes of kernels 3 and 4's sums scratch (gemm.cuh's slab_sums_sizes):
// fp32 elements of `part` and ints of `tickets` for `slabs` slabs of s rows
// and n columns in `chunks` output chunks.
AAT_EXPORT void aat_slab_sums_sizes(int slabs, int s, int n, int chunks, long long* part,
                                    long long* tickets) {
  aat::gemm::slab_sums_sizes(slabs, s, n, chunks, part, tickets);
}
