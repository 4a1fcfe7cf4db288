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
//
// sfc_tile_update: O[i, j] += alpha * A_i . B_j^T over a scheduled subset
// of (i, j) tiles, O updated in place.
//
// Replaces: src/repro/kernels/matmul.py::_accum_update_kernel (the TPU
// kernel of tile_update_swizzled, the per-k Cholesky's trailing SYRK
// update).  Each tile of the schedule is visited once, so the in-place
// read-modify-write needs no ordering between CTAs.  Both operands are
// row panels, A (M, Kp) and B (N, Kp), read by RowLoader as x . c^T is in
// kmeans.cu; the epilogue is tile_gemm.cuh::tile_update, which the fused
// Cholesky's trailing phase (cholesky.cu) runs too.
// Bound on the H100: FP32 FLOP/s (2 M N Kp over the whole grid; TF32 is
// off).  Same SIMT tile product and sub-tile loop as sfc_matmul.
//
// sfc_matmul3d: C = A . B over a 3-D (i, j, k) curve table.
//
// Replaces: src/repro/kernels/matmul.py::_matmul3d_kernel (the TPU kernel
// of matmul_swizzled_3d, ops.matmul(schedule_ndim=3)).  There every grid
// step is one (i, j, k) tile product read-modify-written into the f32
// output block, and the k tiles of one output tile are not adjacent in
// the grid.  On a GPU, concurrent CTAs must not read-modify-write one
// tile, so the host turns the table into a CSR (kernels/matmul.py:
// matmul3d_csr): the (i, j) tiles in first-visit order, one CTA each,
// launched in that order, and per tile its k tiles in the order the 3-D
// table visits them.  The CTA walks its own k list in that order (the
// JAX kernel's summation order), keeps the accumulator in registers
// across the k tiles (tile_gemm.cuh::tile_accumulate) and writes C once.
// Bound on the H100: FP32 FLOP/s (2 M N K; TF32 is off), as sfc_matmul.
// Design: the same SIMT tile product; the curve order of the (i, j)
// first visits decides which panels neighbouring CTAs share in L2, and
// each CTA's k order which depth panels it streams first.
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

__global__ void __launch_bounds__(THREADS)
tile_update_kernel(float* O, const float* A, const float* B, const int* __restrict__ sched, int M,
                   int N, int Kp, int bm, int bn, float alpha) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = sched[2 * (size_t)blockIdx.x];
  const int tj = sched[2 * (size_t)blockIdx.x + 1];
  for (int sr = 0; sr < bm; sr += TILE) {
    const int row0 = ti * bm + sr;
    const int rows = min(min(TILE, bm - sr), M - row0);
    for (int sc = 0; sc < bn; sc += TILE) {
      const int col0 = tj * bn + sc;
      const int cols = min(min(TILE, bn - sc), N - col0);
      tile_update(O + (size_t)row0 * N + col0, (size_t)N, A + (size_t)row0 * Kp, (size_t)Kp,
                  B + (size_t)col0 * Kp, (size_t)Kp, rows, cols, Kp, alpha, As, Bs);
    }
  }
}

// CTA r owns output tile (i, j) = ij[r] and adds A(i, k) B(k, j) for k =
// ks[r kt], ..., ks[r kt + kt - 1] in that order; K % bk == 0.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
matmul3d_kernel(const T* __restrict__ A, const T* __restrict__ B, TO* __restrict__ C,
                const int* __restrict__ ij, const int* __restrict__ ks, int kt, int M, int N,
                int K, int bm, int bn, int bk) {
  __shared__ __align__(16) float As[BK * TILE];
  __shared__ __align__(16) float Bs[BK * TILE];
  const int ti = ij[2 * (size_t)blockIdx.x];
  const int tj = ij[2 * (size_t)blockIdx.x + 1];
  const int* kr = ks + (size_t)blockIdx.x * kt;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int sr = 0; sr < bm; sr += TILE) {
    const int row0 = ti * bm + sr;
    const int rows = min(min(TILE, bm - sr), M - row0);
    for (int sc = 0; sc < bn; sc += TILE) {
      const int col0 = tj * bn + sc;
      const int cols = min(min(TILE, bn - sc), N - col0);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int q = 0; q < kt; ++q) {
        const size_t k0 = (size_t)kr[q] * bk;
        RowLoader<T> la{A + (size_t)row0 * K + k0, (size_t)K, rows, bk};
        KLoader<T> lb{B + k0 * N + col0, (size_t)N, cols, bk};
        tile_accumulate<false>(acc, la, lb, bk, As, Bs, nullptr);
      }
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
int launch3d(const void* a, const void* b, void* c, const void* ij, const void* ks, int steps,
             int kt, int M, int N, int K, int bm, int bn, int bk, void* stream) {
  matmul3d_kernel<T, TO><<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (TO*)c, (const int*)ij, (const int*)ks, kt, M, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfc_tile_update(void* o, const void* a, const void* b, const void* sched, int steps,
                               int M, int N, int Kp, int bm, int bn, float alpha, void* stream) {
  tile_update_kernel<<<steps, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)o, (const float*)a, (const float*)b, (const int*)sched, M, N, Kp, bm, bn, alpha);
  return (int)cudaGetLastError();
}

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

// dtype codes as sfc_matmul's; ij int32[steps, 2], ks int32[steps, kt].
extern "C" int sfc_matmul3d(const void* a, const void* b, void* c, const void* ij, const void* ks,
                            int steps, int kt, int M, int N, int K, int bm, int bn, int bk,
                            int in_dtype, int out_dtype, void* stream) {
  if (in_dtype == 0 && out_dtype == 0)
    return launch3d<float, float>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 0 && out_dtype == 1)
    return launch3d<float, __nv_bfloat16>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 1 && out_dtype == 0)
    return launch3d<__nv_bfloat16, float>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, stream);
  if (in_dtype == 1 && out_dtype == 1)
    return launch3d<__nv_bfloat16, __nv_bfloat16>(a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk,
                                                  stream);
  return (int)cudaErrorInvalidValue;
}
