// sfc_matmul: C = A . B over a curve-ordered table of (i, j) output tiles.
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (the TPU kernel
// of matmul_swizzled).  There the grid is (tiles, k_tiles) and a VMEM
// accumulator lives across the sequential k steps; a GPU grid runs its
// CTAs concurrently and in no order, so here the whole K reduction is a
// loop inside one CTA and each output tile is written exactly once.
//
// Bound on the H100: FP32 FLOP/s.  TF32 is off, so f32 products cannot
// use the tensor cores (67 TFLOP/s on the FP32 pipes); bf16 inputs are
// widened with __bfloat162float and take the same f32 path.  This first
// design is a plain SIMT tile product (tile_gemm.cuh: 128x128 CTA tile,
// 8x8 outputs per thread, 16-deep shared-memory chunks with a register
// prefetch of the next chunk).  The curve order of the schedule decides
// which A row panels and B column panels neighbouring CTAs share in L2.
// No wgmma, no TMA: those are later work.
//
// CTA s reads (i, j) = sched[s]; a (bm, bn) tile wider than 128 is
// covered by a loop of 128x128 sub-tiles inside the CTA.
#include "tile_gemm.cuh"

namespace {

using namespace sfc;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, TO* __restrict__ C,
              const int* __restrict__ sched, int M, int N, int K, int bm, int bn) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int sr = 0; sr < bm; sr += TILE) {
    const int row0 = ti * bm + sr;
    const int rows = min(min(TILE, bm - sr), M - row0);
    for (int sc = 0; sc < bn; sc += TILE) {
      const int col0 = tj * bn + sc;
      const int cols = min(min(TILE, bn - sc), N - col0);
      RowLoader<T> la{A + (size_t)row0 * K, (size_t)K, rows, K};
      KLoader<T> lb{B + col0, (size_t)N, cols, K};
      float acc[8][8];
      tile_product<false>(acc, la, lb, K, As, Bs, nullptr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tile_row(ty, i);
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tile_col(tx, j);
          if (c < cols) store_out(C + (size_t)(row0 + r) * N + col0 + c, acc[i][j]);
        }
      }
    }
  }
}

template <typename T, typename TO>
int launch(const void* a, const void* b, void* c, const void* sched, int steps, int M, int N,
           int K, int bm, int bn, void* stream) {
  matmul_kernel<T, TO><<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (TO*)c, (const int*)sched, M, N, K, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (inputs share one dtype).
extern "C" int sfc_matmul(const void* a, const void* b, void* c, const void* sched, int steps,
                          int M, int N, int K, int bm, int bn, int in_dtype, int out_dtype,
                          void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, sched, steps, M, N, K, bm, bn, stream);
  return (int)cudaErrorInvalidValue;
}
